"""Probes of the Hopper kernels K1 (``csrc/fused_window_attention.cu``), K2
(``csrc/fused_global_attention.cu``), K3 (``csrc/flash_attention.cu``), K4
(``csrc/window_attention_bwd.cu``), the K5 forward
(``csrc/global_attention_fwd_lse.cu``; K2's and its Hopper body in
``csrc/global_fwd_hopper.cuh``),
the K5 backward (``csrc/global_attention_bwd_dkv.cu``,
``csrc/global_attention_bwd_dq.cu``), the K6 forward
(``csrc/flash_attention_fwd.cu``), the K6 backward
(``csrc/flash_attention_bwd_dkv.cu``, ``csrc/flash_attention_bwd_dq.cu``),
K7 (``csrc/fused_ln_mlp_residual.cu``) and K8 (``csrc/int8_matmul.cu``) on
the GPU.

Two measurements that ``chip_smoke.py`` does not make::

    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k1
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k2
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k3
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k4
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k5fwd
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k5dkv
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k5dq
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6dkv
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6dq
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6fwd
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k1f32
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k2f32
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k3f32
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k7
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k7wide
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k8
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path fast PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path parity PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path parity-forward PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path fast-768 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path frozen PARENT CHANGE

``variants`` builds copies of one kernel's source with one constant or one
step changed (K1: the number of buffered work items or of consumer
warpgroups; K2: the ring depth or the consumer warpgroups; K3 bf16: 64-key
tiles with the masked columns in bias_w instead of 48-key boxes, two
consumer warpgroups, the ring depth; K4: one
warpgroup, the bias rows read from device memory instead of staged by
bulk copy, the bias gradients' product or the bias tile's build removed, phase A or phase B (the key-major recompute)
removed, phase B's dk/dv products removed; the K5 forward: two consumer
warpgroups, the ring depth, Q^ formed in the shared Q tile instead of in
the A fragments; the
K5 backward: three consumer warpgroups, the ring depth, the bias step
removed; the K6 backward: one tile buffer instead of two, or 64-column
tiles, a 4 x 8 score micro-tile; the register-tiled fp32 forward of K1,
K2, K3 and K6 (``csrc/f32_tiled_forward.cuh``, ``k1f32``, ``k2f32``,
``k3f32`` and ``k6fwd``): 64-key tiles, which make the score micro-tile 4 x
8, two tile buffers, P in a tile of its own, all of K3's grid columns
visited, K1's ragged fourth row block of a window not launched, the bias
step removed;
for all the softmax (K5 and K6: the exp2/dS step) or the products
removed, and for K5, K6 and the fp32 forward the score (and dP)
products removed; K7's Hopper body: two ring slots a warpgroup, the
hardware tanh in the GELU, the GELU or either product removed; K7's C
1536 loop (``k7wide``): the weight chunks copied synchronously, or both of
a chunk's copy groups waited for before its first product; K8: the
ring depth: timing ablations
whose output is wrong by design where a step is removed),
calls each through ``ctypes`` at its path's shapes (K1: q (100, 196, 768),
Kh = Kw = 14; K2: q (4, 4096, 768), Kh = Kw = 64, and DINOv2's kv_len
shape, 4 x 1536 with 1370 valid; K3 bf16: SAM @768's q (4, 12, 2304, 64)
and JAX's padded (4, 12, 3072, 64) against k/v (4, 12, 3072, 64), Kh 48,
Kw 64, ``kv_grid`` (48, 48); K4: q (50, 196, 768), Kh = Kw = 14; K5:
q (2, 4096, 768), Kh = Kw = 64, and the kv_len shape at B=2, bf16, the
forward's out and lse held to its plain version; K6: the
`parity` path's SAM global (2, 12, 4096, 64), Kh = Kw = 64, and windowed
(50, 12, 196, 64), Kh = Kw = 14, fp32 (the forward also DINOv2's (2, 12,
1536, 64) with 1370 valid keys); K1 fp32: q (100, 196, 768), Kh = Kw =
14; K2 fp32: q (4, 4096, 768), Kh = Kw = 64, and DINOv2's kv_len shape;
K3 fp32: SAM @768's q (4, 12, 2304, 64), k/v 3072 rows, Kh 48, Kw 64,
``kv_grid`` (48, 48), and (4, 12, 1536, 64) with 1370 valid keys; K7:
SAM's 16384 rows and DINOv2's 4 x 1370 with a layerscale, C 768, hidden
3072, bf16; ``k7wide``: ViT-g/14's 4 x 1370 with a layerscale, C 1536,
hidden 6144, bf16; K8: an `int8` forward's ten shapes, with the sum over its 60
launches), and prints its gap to the
plain version and its time (K1/K2 and the fp32 forward beside SDPA's, K4
and K5 beside the bf16 tensor-core peak, K6 beside the fp32 CUDA cores'
peak).
A variant that changes a header (the fp32 forward's steps) builds from
its own directory, which holds the changed copy.
``pair`` runs two checkouts in turns (parent, change,
change, parent), each in a fresh process: with ``--path extraction`` (the
default) 10 `fast` SAM ViT-B/16 @1024 forwards at B=4 on the host clock,
then ``chip_smoke.py``'s extraction phase; with ``--path fast`` or
``--path parity`` 5 fine-tuning steps of SAM ViT-B/16 @1024 and of DINOv2
ViT-B/14 @518 at B=2 under that policy (``chip_smoke.py``'s phases 8 and
13, or 12 and 13: host clock, steady = steps 3-5), the device time of a
step of each (``utils/profiling.py``), then its kernel phases
7 and 11 (K4, the K5 forward and backward, K2 in kv_len mode; `fast`) or
10 (K6; `parity`), `fast` also K2 bf16 at phase 3's shapes (ms and a
SHA-256 of its output bits, which must not differ between the trees); with ``--path
parity-forward`` 5 `parity` SAM ViT-B/16 forwards at B=4 @1024 (K2 fp32)
and @768 (K3 fp32) on the host clock, each after a warm-up, and their
device ms (``utils/profiling.py``), then K2 and K3
in fp32 at their path shapes and at DINOv2's kv_len shape, and
``chip_smoke.py``'s kernel phases 3 and 15; with ``--path fast-768`` the
`fast` SAM @768 forward at B=4 (host and device ms, ``utils/profiling.py``)
and a one-patient @768 extraction as ``chip_smoke.py``'s phase 18 runs it;
with ``--path frozen`` the `fast`, `int8` (K8) and ``VDR_FUSED_MLP=1`` (K7)
SAM @1024 forwards at B=4 (host ms, device ms from ``utils/profiling.py``),
a one-patient extraction of each, and ``chip_smoke.py``'s kernel phases 16
and 17 (K7 and K8).
Nothing is built or run at import.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

__all__ = ["SOURCES", "HEADERS", "VARIANTS", "CALLS", "variant_source",
           "variant_files", "main"]

SOURCES = {"k1": "fused_window_attention.cu",
           "k1f32": "fused_window_attention.cu",
           "k3": "flash_attention.cu",
           "k2": "fused_global_attention.cu",
           "k4": "window_attention_bwd.cu",
           "k6fwd": "flash_attention_fwd.cu",
           "k5fwd": "global_attention_fwd_lse.cu",
           "k6dkv": "flash_attention_bwd_dkv.cu",
           "k6dq": "flash_attention_bwd_dq.cu",
           "k5dkv": "global_attention_bwd_dkv.cu",
           "k5dq": "global_attention_bwd_dq.cu",
           "k2f32": "fused_global_attention.cu",
           "k3f32": "flash_attention.cu",
           "k7": "fused_ln_mlp_residual.cu",
           "k7wide": "fused_ln_mlp_residual.cu",
           "k8": "int8_matmul.cu"}
# headers a variant of the kernel may change (copied beside its source)
HEADERS = {"k2": ("global_fwd_hopper.cuh",),
           "k5fwd": ("global_fwd_hopper.cuh",),
           "k1f32": ("f32_tiled_forward.cuh",),
           "k2f32": ("f32_tiled_forward.cuh",),
           "k3f32": ("f32_tiled_forward.cuh",),
           "k6fwd": ("f32_tiled_forward.cuh",)}
# the register-tiled fp32 forward (f32_tiled_forward.cuh) of K2 and K3
_F32_TILED = {
    "as_built": ({}, ()),   # one tile buffer, P in the tile's K buffer
    "cols_64": ({"kF32Cols": 64}, ()),   # 64-key tiles: a 4 x 8 micro-tile
    "stages_2": ({"kF32Stages": 2}, ()),
    "p_tile": ({"kF32PInK": 0}, ()),     # P in a [kCols][LP] tile of its own
    "stages_2_p_tile": ({"kF32Stages": 2, "kF32PInK": 0}, ()),
    "no_bias": ({}, (("x = __fadd_rn(x, __fadd_rn(bias_s[ho[j] + row],\n"
                      "                                     "
                      "bias_s[wo[j] + row]));", ";"),)),
    # scores minus the thread's own max: no shuffles, no exponentials
    "no_softmax": ({}, (
        ("mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));", ";"),
        ("alpha[i] = exp2f(m[i] - mx);", "alpha[i] = 1.f;"),
        ("s[i][j] = exp2f(s[i][j] - mx);", "s[i][j] -= mx;"))),
    "no_scores": ({}, ("chain<0, D>(s, qs, st);",)),
    "no_products": ({}, ("accumulate<kCols>(acc, pt, st + kCols * LD);",)),
}
# K7's four GELU calls (the elements of a thread's two rows and columns)
_K7_G = (("", 0), (" + 1", 1), (" + 2", 0), (" + 3", 1))
# kernel: {name: (substitutions of `constexpr` values, calls removed, or
# (text, replacement) pairs)}
VARIANTS = {
    # K7's Hopper body (bf16, C 768): two ring slots a warpgroup, the
    # hardware tanh (tanh.approx.f32) in the GELU, the GELU or either
    # product removed
    "k7": {
        "as_built": ({}, ()),
        "stages_2": ({"kStagesH": 2}, ()),
        "gelu_approx": ({}, ((
            "return x * (0.5f * (1.f + tanhf(inner)));",
            "float t;\n  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(t) : "
            "\"f\"(inner));\n  return x * (0.5f * (1.f + t));"),)),
        "no_gelu": ({}, tuple(
            (f"gelu_tanh(acc1[4 * i{e}] + bb{e2})",
             f"(acc1[4 * i{e}] + bb{e2})") for e, e2 in _K7_G)),
        "no_first_product": ({}, (
            "Wgmma<kHalf>::ss(acc1, da + 2 * kk, dw + 2 * kk,\n"
            "                             s + b + kk > 0);",)),
        "no_second_product": ({}, (
            "Wgmma<128>::ss(acc2[ob], dg + (hb * kBox >> 4) + 2 * kk,\n"
            "                         dw + 2 * kk, j + hb + kk > 0);",)),
    },
    # K7's loop at C 1536 (DINOv2 ViT-g/14): the weight chunks copied
    # synchronously (a load's latency paid per 16 bytes, the first
    # version), or by cp.async with both of a chunk's groups waited for
    # before its first product (no overlap with the products)
    "k7wide": {
        "as_built": ({}, ()),
        "sync_staging": ({}, ((
            'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(\n'
            '                   vdr::sm90::smem_u32(smem)),\n'
            '               "l"(gmem)\n'
            '               : "memory");',
            "*reinterpret_cast<uint4*>(smem) =\n"
            "      *reinterpret_cast<const uint4*>(gmem);"),)),
        "one_group": ({}, ((
            "cp_async_wait<1>();   // this chunk's w1 (its w2 may be in "
            "flight)",
            "cp_async_wait<0>();"),)),
        # 16-row blocks (177 KB of shared memory, 96 accumulators a
        # thread): twice the weight reads from L2
        "rows_16": ({"kRowsG": 16}, ()),
    },
    # K8: the ring depth
    "k8": {
        "as_built": ({}, ()),
        "stages_2": ({"kStages": 2}, ()),
        "stages_3": ({"kStages": 3}, ()),
        "stages_4": ({"kStages": 4}, ()),
    },
    "k1": {
        "as_built": ({}, ()),
        "buffers_1": ({"kBuffers": 1}, ()),
        "consumers_1": ({"kConsumers": 1}, ()),
        "no_softmax": ({}, ("softmax_rows<N>(s, pa, p.scale_log2, l_lo, "
                            "l_hi);",)),
        "no_products": ({}, (
            "qk_products<N>(s, ba, nb, q_addr, k_addr, e_addr);",
            "pv_products<N>(o, pa, v_addr);")),
    },
    "k2": {
        "as_built": ({}, ()),
        "stages_4": ({"kStages": 4}, ()),
        "consumers_2": ({"kConsumers": 2}, ()),
        "no_softmax": ({}, ("probs(0);", "probs(j);")),
        "no_products": ({}, (
            "qk_tile<kBK>(s, qa, k_addr);",
            "qk_tile<kBK>(s, qa, k_addr + cur * kTile);",
            "pv_tile<kBK>(o, pa, v_addr + prev * kTile);",
            "pv_tile<kBK>(o, pa, v_addr + last * kTile);")),
    },
    # K3's Hopper body (bf16): 64-key tiles with the masked columns in
    # bias_w instead of 48-key boxes, two consumer warpgroups, the ring
    # depth; the softmax or the products removed
    "k3": {
        "as_built": ({}, ()),
        "cols_64": ({"kSkipCols": 0}, ()),
        "consumers_2": ({"kConsumers": 2}, ()),
        "stages_6": ({"kStages": 6}, ()),
        "stages_8": ({"kStages": 8}, ()),
        "no_softmax": ({}, ("probs(0);", "probs(j);")),
        "no_products": ({}, (
            "qk_tile<NK>(s, qa, k_addr);",
            "qk_tile<NK>(s, qa, k_addr + cur * kKTile);",
            "pv_tile<NK>(o, pa, v_addr + prev * kKTile);",
            "pv_tile<NK>(o, pa, v_addr + last * kKTile);")),
    },
    "k6dkv": {
        "as_built": ({}, ()),
        "stages_1": ({"kStages": 1}, ()),
        "cols_64": ({"kCols": 64}, ()),
        "no_softmax": ({}, ("p_ds(s, dp, st);",)),
        "no_products": ({}, ("accumulate<kCols>(dv, ps, st + kCols * LD);",
                             "accumulate<kCols>(dk, dss, st);")),
        "no_scores": ({}, ("score_tile(s, ks, qs);",
                           "dp_tile(dp, vs, st + kCols * LD);")),
    },
    "k6dq": {
        "as_built": ({}, ()),
        "stages_1": ({"kStages": 1}, ()),
        "cols_64": ({"kCols": 64}, ()),
        # dS = S + dP: the scores stay live (removing p_ds would drop them)
        "no_softmax": ({}, (("exp2f(sv - lse_s[row]) * (dp[i][j] - dl_s[row])",
                             "sv + dp[i][j]"),)),
        "no_products": ({}, ("accumulate<kCols>(dq, dss, st);",)),
        "no_scores": ({}, ("score_tile(s, qs, st);",
                           "dp_tile(dp, dos, st + kCols * LD);")),
    },
    # the K5 forward on K2's Hopper body (global_fwd_hopper.cuh): two
    # consumer warpgroups (128-row blocks), the ring depth (K2's 6; more
    # leave no room for a 128-row bias_h table), Q^ formed in the shared Q
    # tile; the softmax or the products removed
    "k5fwd": {
        "as_built": ({}, ()),
        "consumers_2": ({"kConsumers": 2}, ()),
        "stages_3": ({"kStages": 3}, ()),
        "stages_6": ({"kStages": 6}, ()),
        # each warpgroup scales its shared Q tile in place (the swizzle
        # permutes 16-byte chunks, so chunk k scaled stays chunk k)
        "qhat_smem": ({}, ((
            "q_frags_scaled(qa, base + wg * kTile, warp, g, c, p.scale_log2);",
            "{\n      uint4* tile = reinterpret_cast<uint4*>(base + wg * "
            "kTile);\n      for (int k = t; k < kTile / 16; k += 128) {\n"
            "        uint4 v = tile[k];\n        uint32_t* w = "
            "reinterpret_cast<uint32_t*>(&v);\n        for (int i = 0; i < 4;"
            " ++i) {\n          const __nv_bfloat162 x = *reinterpret_cast<"
            "const __nv_bfloat162*>(&w[i]);\n          w[i] = vdr::pack_bf16("
            "__low2float(x) * p.scale_log2, __high2float(x) * "
            "p.scale_log2);\n        }\n        tile[k] = v;\n      }\n"
            "      bar_sync(1 + wg, 128);\n      q_frags(qa, base + wg * "
            "kTile, warp, g, c);\n    }"),)),
        "no_softmax": ({}, ("probs(0);", "probs(j);")),
        "no_products": ({}, (
            "qk_tile<kBK>(s, qa, k_addr);",
            "qk_tile<kBK>(s, qa, k_addr + cur * kTile);",
            "pv_tile<kBK>(o, pa, v_addr + prev * kTile);",
            "pv_tile<kBK>(o, pa, v_addr + last * kTile);")),
    },
    "k5dkv": {
        "as_built": ({}, ()),
        "consumers_3": ({"kConsumers": 3}, ()),
        "stages_3": ({"kStages": 3}, ()),
        "stages_5": ({"kStages": 5}, ()),
        "no_bias": ({}, ("add_bias(s, sm + 128 + 64 * wg, bw_tile, warp, "
                         "lane, c);",)),
        "no_softmax": ({}, ("probs_ds(s, dp, sm, sm + 64, c, ragged, lo_ok, "
                            "hi_ok);",)),
        "no_products": ({}, ("grads_tile(dv, dk, pa, sa, prev + kTile, prev);",
                             "grads_tile(dv, dk, pa, sa, last + kTile, "
                             "last);")),
        "no_scores": ({}, (
            "scores_tile(s, dp, k_tile, v_tile, first + 2 * kTile, "
            "first + kTile);",
            "scores_tile(s, dp, k_tile, v_tile, cur + 2 * kTile, "
            "cur + kTile);")),
    },
    "k5dq": {
        "as_built": ({}, ()),
        "consumers_3": ({"kConsumers": 3}, ()),
        "stages_2": ({"kStages": 2}, ()),
        "stages_6": ({"kStages": 6}, ()),
        "no_bias": ({}, ("add_bias(s, bw, bh[r_lo], bh[r_hi]);",
                         "bias_grads(dp, dbw, dbh_lo, dbh_hi, kr, c);")),
        "no_softmax": ({}, ("probs_ds(s, dp, l_lo, l_hi, d_lo, d_hi, ragged, "
                            "j * 64 + 2 * c, n_keys);",)),
        "no_products": ({}, ("vdr::k5h::product_rs(dq, da, prev);",
                             "vdr::k5h::product_rs(dq, da, last);")),
        "no_scores": ({}, (
            "scores_tile(s, dp, q_addr, do_addr, ring, ring + kTile);",
            "scores_tile(s, dp, q_addr, do_addr, cur, cur + kTile);")),
    },
    "k4": {
        "as_built": ({}, ()),
        "consumers_1": ({"kConsumers": 1}, ()),
        "bias_rows_global": ({"kBiasBulk": 0}, ()),
        "no_dbias": ({}, ("Wgmma<64>::rs<1>(db, da[kt], mn_desc(sm.e, kt), "
                          "1);",)),
        "no_bias_tile": ({}, ("build_bias_tile(p, sm, item, base + p.rows "
                              "* 128);",)),
        "no_phase_a": ({}, ("query_tile<N>(p, sm, item, tile);",)),
        "no_phase_b": ({}, ("key_tile(p, sm, item, tile);",)),
        "no_key_products": ({}, (
            "Wgmma<64>::rs<1>(dv, pa[kt], mn_desc(sm.dout + q0 * 128, kt), "
            "1);",
            "Wgmma<64>::rs<1>(dk, sa[kt], mn_desc(sm.q + q0 * 128, kt), "
            "1);")),
    },
    # the K6 forward on the tiled body: its score is the split chain pair
    "k6fwd": {
        **{k: v for k, v in _F32_TILED.items() if k != "no_scores"},
        "no_scores": ({}, ("score_tile(s, qs, st);",)),
        "no_products": ({}, ("accumulate<kCols>(tile, pt, st + kCols * LD);",)),
        # O summed key by key, as K2 and K3 sum it
        "no_tile_sum": ({"kF32TileSum": 0}, ()),
    },
    # K1 (two tile buffers as built): one buffer, and the windows' fourth
    # 64-row block (4 of 196 rows) not launched
    "k1f32": {**{k: v for k, v in _F32_TILED.items()
                 if not k.startswith("stages_")},
              "stages_1": ({"kF32Stages": 1}, ()),
              "no_ragged_block": ({}, ((
                  "(p.seg + vdr::tiled::ROWS - 1) / vdr::tiled::ROWS,",
                  "p.seg / vdr::tiled::ROWS,"),))},
    "k2f32": _F32_TILED,
    # K3 also: every column of a padded key grid visited (the masked ones
    # scored at -1e30) instead of the valid ones alone
    "k3f32": {**_F32_TILED, "all_cols": ({"kF32SkipCols": 0}, ())},
}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _k1_call(A, q, kv, bh, bw, kl, heads, scale):
    """K1's plain output, and its entry point's arguments before the dtype
    code and the stream: one window a batch row, as the extraction path
    gives it."""
    b, s, c = q.shape
    ref = A.fused_window_attention_plain(q, kv, bh, bw, num_heads=heads,
                                         window_tokens=s, scale=scale)
    return ref, lambda out: (q, kv, bh, bw, out, b, s, heads, c // heads, s,
                             bh.shape[-1], bw.shape[-1], scale)


def _k2_call(A, q, kv, bh, bw, kl, heads, scale):
    b, s, c = q.shape
    kh, kw = (bh.shape[-1], bw.shape[-1]) if bh is not None else (0, 0)
    ref = A.fused_global_attention_plain(q, kv, bh, bw, kl, num_heads=heads,
                                         scale=scale)
    return ref, lambda out: (q, kv, bh, bw, kl, out, b, s, heads,
                             c // heads, kh, kw, scale)


# kernel: (entry point's argument types, shapes (B, S, Kh, Kw, kv_len),
# the plain output and the arguments; None for the K6 backward, which
# `_k6_variants` calls)
_K6_SHAPES = ((2, 4096, 64, 64, None), (50, 196, 14, 14, None))
# the K5 backward (bf16): SAM @1024's global layers and DINOv2's kv_len
_K5_SHAPES = ((2, 4096, 64, 64, None), (2, 1536, 0, 0, 1370))
CALLS = {
    "k1": ([_P] * 5 + [_I] * 7 + [_F, _I, _P], ((100, 196, 14, 14, None),),
           _k1_call),
    "k2": ([_P] * 6 + [_I] * 6 + [_F, _I, _P],
           ((4, 4096, 64, 64, None), (4, 1536, 0, 0, 1370)), _k2_call),
    "k4": ([_P] * 10 + [_I] * 7 + [_F, _P], ((50, 196, 14, 14, None),), None),
    "k6fwd": ([_P] * 8 + [_I] * 6 + [_F, _P],
              (*_K6_SHAPES, (2, 1536, 0, 0, 1370)), None),
    "k6dkv": ([_P] * 11 + [_I] * 6 + [_F, _P], _K6_SHAPES, None),
    "k6dq": ([_P] * 12 + [_I] * 6 + [_F, _P], _K6_SHAPES, None),
    "k5fwd": ([_P] * 7 + [_I] * 6 + [_F, _P], _K5_SHAPES, None),
    "k5dkv": ([_P] * 9 + [_I] * 6 + [_F, _P], _K5_SHAPES, None),
    "k5dq": ([_P] * 11 + [_I] * 6 + [_F, _P], _K5_SHAPES, None),
    # K3 (head-major; S the query rows, Sk = Kh·Kw or S): SAM @768's 48 x
    # 48 grid padded to 48 x 64 with kv_grid (Kh, Kh), against the 2304
    # query rows the path passes and the 3072 JAX pads them to
    "k3": ([_P] * 7 + [_I] * 10 + [_F, _I, _P],
           ((4, 2304, 48, 64, None), (4, 3072, 48, 64, None)), None),
    # fp32: (B, S, Kh, Kw, kv_len); K1 one window a batch row
    "k1f32": ([_P] * 5 + [_I] * 7 + [_F, _I, _P], ((100, 196, 14, 14, None),),
              None),
    "k2f32": ([_P] * 6 + [_I] * 6 + [_F, _I, _P],
              ((4, 4096, 64, 64, None), (4, 1536, 0, 0, 1370)), None),
    "k3f32": ([_P] * 7 + [_I] * 10 + [_F, _I, _P],
              ((4, 2304, 48, 64, None), (4, 1536, 0, 0, 1370)), None),
    # K7 (rows, with a layerscale): SAM's 4 x 4096 rows, DINOv2's 4 x 1370
    "k7": ([_P] * 9 + [_I] * 3 + [_F, _I, _P],
           ((16384, False), (5480, True)), None),
    "k7wide": ([_P] * 9 + [_I] * 3 + [_F, _I, _P], ((5480, True),), None),
    # K8 (M, K, N): an `int8` forward's ten shapes (chip_smoke.py phase 17)
    "k8": ([_P] * 3 + [_I] * 3 + [_P], None, None),
}


def variant_source(text: str, consts: dict, removed=()) -> str:
    """A kernel source with `constexpr int` values replaced and, for the
    ablations, the listed calls (a tile's softmax, or its products) taken
    out, or (text, replacement) pairs replaced."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"no single constexpr {name} in the source")
    for call in removed:
        call, repl = call if isinstance(call, tuple) else (call, ";")
        if text.count(call) != 1:
            raise ValueError(f"no single {call} in the source")
        text = text.replace(call, repl)
    return text


def variant_files(kernel: str, name: str) -> dict:
    """One variant's files, name -> text: the kernel's source with its
    constants replaced, and the headers it may change (``HEADERS``), each
    listed removal made in the one file that holds it."""
    from . import cuda_build as cb

    consts, removed = VARIANTS[kernel][name]
    src = SOURCES[kernel]
    files = {f: (cb.CSRC_DIR / f).read_text()
             for f in (src, *HEADERS.get(kernel, ()))}
    files[src] = variant_source(files[src], consts)
    for call in removed:
        text = call[0] if isinstance(call, tuple) else call
        hits = [f for f, body in files.items() if text in body]
        if len(hits) != 1:
            raise ValueError(f"{text} is in {hits}, not in one file")
        files[hits[0]] = variant_source(files[hits[0]], {}, (call,))
    return files


def _ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _build(kernel: str, out_dir: Path) -> dict:
    """Every variant of one kernel, one nvcc each, in parallel: name ->
    the library's entry point."""
    from . import cuda_build as cb

    out_dir.mkdir(parents=True, exist_ok=True)
    entry = "vdr_" + SOURCES[kernel][:-3]
    jobs = {}
    for name in VARIANTS[kernel]:
        # its own directory: a changed header copy there is found first
        vdir = out_dir / f"{kernel}_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, body in variant_files(kernel, name).items():
            (vdir / fname).write_text(body)
        cu = vdir / SOURCES[kernel]
        cmd = [cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR), "-o",
               str(out_dir / f"{kernel}_{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        notes = [ln.strip() for ln in log.splitlines()
                 if "spill" in ln or "C75" in ln or "error" in ln
                 or "registers" in ln or "entry function" in ln]
        print(f"build {kernel} {name}: rc {proc.returncode}; "
              + " | ".join(notes))
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"{kernel}_{name}.so")), entry)
        fn.argtypes = CALLS[kernel][0]
        fns[name] = fn
    return fns


def _variants(kernel: str, out_dir: Path) -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    c = heads * d
    scale = d ** -0.5

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def ptr(t):
        if t is None or isinstance(t, torch.Tensor):
            return ctypes.c_void_p(0 if t is None else t.data_ptr())
        return t

    _, shapes, call = CALLS[kernel]
    for b, s, kh, kw, n_valid in shapes:
        q, kv = rand(b, s, c), rand(b, s, 2 * c)
        bh = bw = kl = None
        if kh:
            bh = rand(b, heads, s, kh, scale=0.3)
            bw = rand(b, heads, s, kw, scale=0.3)
        else:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        ref, args_of = call(A, q, kv, bh, bw, kl, heads, scale)
        ref = ref.float()
        print(f"{kernel} shape q ({b}, {s}, {c}), Kw {kw}, kv_len {n_valid}:")
        for name, fn in fns.items():
            out = torch.empty_like(q)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            args = (*map(ptr, args_of(out)), 1, stream)

            def run(fn=fn, args=args):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = ((out.float() - ref).abs() - 2 ** -7 * ref.abs()).max()
            print(f"  {name}: gap {gap.item():.3e} ms {_ms(torch, run):.4f}")
        heads_of = [t.reshape(b, s, heads, d).transpose(1, 2)
                    for t in (q, kv[..., :c], kv[..., c:])]
        if kh:
            mask = (bh.float()[..., :, None] + bw.float()[..., None, :]
                    ).reshape(b, heads, s, s).to(torch.bfloat16)
        else:
            key = torch.arange(s, device="cuda")
            mask = torch.zeros(b, heads, s, s, device="cuda",
                               dtype=torch.bfloat16).masked_fill(
                key >= n_valid, float("-inf"))
        lib = _ms(torch, lambda: F.scaled_dot_product_attention(
            *heads_of, attn_mask=mask), 10)
        print(f"  sdpa: ms {lib:.4f}")
        del mask, ref
        torch.cuda.empty_cache()


def _k6_variants(kernel: str, out_dir: Path) -> None:
    """The K6 forward's or backward's variants (fp32, per-head (B, H, S,
    D)) at the `parity` path's shapes: gap to the plain version, ms, share
    of the fp32 CUDA-core peak (67 TFLOP/s, H100 SXM) on the keys scored."""
    import torch

    from ..ops import attention_grad as G

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    scale = d ** -0.5

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, n_valid in CALLS[kernel][1]:
        q, k, v, dout = (torch.randn(b, heads, s, d, generator=gen,
                                     device="cuda") for _ in range(4))
        bh = bw = kl = None
        if kh:
            bh, bw = (torch.randn(b, heads, s, n, generator=gen,
                                  device="cuda") * 0.3 for n in (kh, kw))
        if n_valid:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        pairs = b * heads * s * (n_valid or s) * d
        if kernel == "k6fwd":
            args = (q, k, v, bh, bw, kl)
            ref = G.flash_attention_fwd_plain(*args, scale=scale)
            flops = 4.0 * pairs
        else:
            out, lse = G.flash_attention_fwd(q, k, v, bh, bw, kl, scale=scale)
            args = (q, k, v, bh, bw, kl, dout, lse,
                    G.flash_attention_delta(out, dout))
            del out
        if kernel == "k6dq":
            ref = G.flash_attention_bwd_dq_plain(*args, scale=scale)
            flops = 6.0 * pairs
        elif kernel == "k6dkv":
            ref = G.flash_attention_bwd_dkv_plain(*args, scale=scale)
            flops = 8.0 * pairs
        print(f"{kernel} shape ({b}, {heads}, {s}, {d}), Kh {kh}, Kw {kw}, "
              f"kv_len {n_valid}:")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, fn in fns.items():
            outs = [None if r is None else torch.empty_like(r) for r in ref]
            c_args = (*map(ptr, (*args, *outs)), b, heads, s, d, kh, kw,
                      scale, stream)

            def run(fn=fn, c_args=c_args):
                rc = fn(*c_args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = max((o - r).abs().max().item()
                      for o, r in zip(outs, ref) if r is not None)
            ms = _ms(torch, run, 10)
            print(f"  {name}: gap {gap:.3e} ms {ms:.4f} "
                  f"({flops / (ms * 1e-3) / 67e12:.1%} of 67 TFLOP/s)")
        del q, k, v, dout, bh, bw, kl, args, ref
        torch.cuda.empty_cache()


def _k5_variants(kernel: str, out_dir: Path) -> None:
    """The K5 forward's or backward's variants (bf16, the port's (B, S,
    H·D) layouts) at the `fast` path's shapes: gap to the plain version
    beyond one bf16 step (the forward's lse: beyond 2^-7·|lse|), ms, share
    of the bf16 tensor-core peak (989 TFLOP/s, H100 SXM)."""
    import torch

    from ..ops import attention_grad as G

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5

    def rand(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(torch.bfloat16)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, n_valid in CALLS[kernel][1]:
        q, kv, dout = rand(b, s, c), rand(b, s, 2 * c), rand(b, s, c)
        bh = bw = kl = None
        if kh:
            bh, bw = rand(b, heads, s, kh, s=0.3), rand(b, heads, s, kw, s=0.3)
        else:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        kwargs = dict(num_heads=heads, scale=scale)
        pairs = b * heads * s * (n_valid or s)
        if kernel == "k5fwd":
            args = (q, kv, bh, bw, kl)
            ref = G.global_attention_fwd_lse_plain(*args, **kwargs)
            flops = 4.0 * pairs * d
        else:
            out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, kl,
                                                  **kwargs)
            args = (q, kv, bh, bw, kl, dout, lse,
                    G.attention_delta(out, dout, heads))
            del out, lse
        if kernel == "k5dq":
            ref = G.global_attention_bwd_dq_plain(*args, **kwargs)
            flops = 6.0 * pairs * d
        elif kernel == "k5dkv":
            ref = (G.global_attention_bwd_dkv_plain(*args, **kwargs),)
            flops = 8.0 * pairs * d
        print(f"{kernel} shape q ({b}, {s}, {c}), Kw {kw}, kv_len {n_valid}:")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, fn in fns.items():
            outs = [None if r is None else torch.empty_like(r) for r in ref]
            c_args = (*map(ptr, (*args, *outs)), b, s, heads, d, kh, kw,
                      scale, stream)

            def run(fn=fn, c_args=c_args):
                rc = fn(*c_args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = max(((o.float() - r.float()).abs()
                       - 2 ** -7 * r.float().abs()).max().item()
                      for o, r in zip(outs, ref) if r is not None)
            ms = _ms(torch, run, 10)
            print(f"  {name}: gap {gap:.3e} ms {ms:.4f} "
                  f"({flops / (ms * 1e-3) / 989e12:.1%} of 989 TFLOP/s)")
        del q, kv, dout, bh, bw, args, ref
        torch.cuda.empty_cache()


def _k4_variants(kernel: str, out_dir: Path) -> None:
    """K4's variants (bf16, the port's (B, S, H·D) layouts) at the `fast`
    path's shape, 50 windows of 14 x 14 tokens: gap to the plain version
    beyond one bf16 step, ms beside SDPA's backward (the dense bias a
    trainable ``attn_mask``), and the share of the 0.0399 ms bound (bytes,
    H100 SXM) it reaches."""
    import torch

    from ..ops import attention as A
    from ..ops import attention_grad as G

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5

    def rand(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(torch.bfloat16)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, _ in CALLS[kernel][1]:
        q, kv, dout = rand(b, s, c), rand(b, s, 2 * c), rand(b, s, c)
        bh, bw = rand(b, heads, s, kh, s=0.3), rand(b, heads, s, kw, s=0.3)
        kwargs = dict(num_heads=heads, window_tokens=s, scale=scale)
        out = A.fused_window_attention(q, kv, bh, bw, **kwargs)
        args = (q, kv, bh, bw, out, dout)
        ref = G.window_attention_bwd_plain(*args, **kwargs)
        nbytes = sum(t.numel() * 2 for t in (*args, *ref))
        bound = nbytes / 3.35e12 * 1e3
        print(f"{kernel} shape q ({b}, {s}, {c}), Kh {kh}, Kw {kw} "
              f"(bound {bound:.4f} ms, bytes):")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, fn in fns.items():
            outs = [torch.empty_like(r) for r in ref]
            c_args = (*map(ptr, (*args, *outs)), b, s, heads, d, s, kh, kw,
                      scale, stream)

            def run(fn=fn, c_args=c_args):
                rc = fn(*c_args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = max(((o.float() - r.float()).abs()
                       - 2 ** -7 * r.float().abs()).max().item()
                      for o, r in zip(outs, ref))
            ms = _ms(torch, run, 20)
            print(f"  {name}: gap {gap:.3e} ms {ms:.4f} "
                  f"({bound / ms:.1%} of the bound)")
        heads_of = [t.reshape(b, s, heads, d).transpose(1, 2).detach()
                    .requires_grad_() for t in (q, kv[..., :c], kv[..., c:])]
        mask = (bh.float()[..., :, None] + bw.float()[..., None, :]).reshape(
            b, heads, s, s).to(torch.bfloat16).requires_grad_()
        o = torch.nn.functional.scaled_dot_product_attention(
            *heads_of, attn_mask=mask, scale=scale)
        g = dout.reshape(b, s, heads, d).transpose(1, 2)
        lib = _ms(torch, lambda: torch.autograd.grad(
            o, [*heads_of, mask], g, retain_graph=True), 10)
        print(f"  sdpa backward: ms {lib:.4f}")
        del q, kv, dout, bh, bw, out, args, ref, heads_of, mask, o
        torch.cuda.empty_cache()


def _forward_variants(kernel: str, out_dir: Path) -> None:
    """The variants of the fp32 forward (K1 and K2: the port's (B, S, H·D)
    layouts, K1 one window a batch row; K3: head-major (B, H, S, D)) at the
    `parity` paths' shapes, and of K3's bf16 Hopper body at SAM @768's: gap
    to the plain version (bf16: beyond one step, 2^-7·|ref|), ms beside
    SDPA's in the same dtype (the dense bias, or -inf at every masked key,
    as ``attn_mask``), share of the fp32 CUDA-core peak (67 TFLOP/s) or of
    the bf16 tensor-core peak (989 TFLOP/s, H100 SXM) on the work the call
    is handed."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5
    bf16 = kernel == "k3"
    dtype = torch.bfloat16 if bf16 else torch.float32
    peak, rtol = (989e12, 2 ** -7) if bf16 else (67e12, 0.0)

    def rand(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, n_valid in CALLS[kernel][1]:
        bh = bw = kl = grid = None
        if kh:
            bh, bw = rand(b, heads, s, kh, s=0.3), rand(b, heads, s, kw, s=0.3)
            grid = (kh, kh) if kernel.startswith("k3") else None
        else:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        sk = kh * kw if kh else s
        if kernel in ("k1f32", "k2f32"):
            q, kv = rand(b, s, c), rand(b, s, 2 * c)
            views = [t.reshape(b, s, heads, d).transpose(1, 2)
                     for t in (q, kv[..., :c], kv[..., c:])]
        if kernel == "k1f32":
            ref = A.fused_window_attention_plain(
                q, kv, bh, bw, num_heads=heads, window_tokens=s, scale=scale)

            def c_args(out):
                return (*map(ptr, (q, kv, bh, bw, out)), b, s, heads, d, s,
                        kh, kw, scale)
        elif kernel == "k2f32":
            ref = A.fused_global_attention_plain(q, kv, bh, bw, kl,
                                                 num_heads=heads, scale=scale)

            def c_args(out):
                return (*map(ptr, (q, kv, bh, bw, kl, out)), b, s, heads, d,
                        kh, kw, scale)
        else:
            q, k, v = (rand(b, heads, n, d) for n in (s, sk, sk))
            ref = A.flash_attention_plain(q, k, v, bh, bw, kl, kv_grid=grid,
                                          scale=scale)
            views = [q, k, v]

            def c_args(out):
                return (*map(ptr, (q, k, v, bh, bw, kl, out)), b, heads, s,
                        sk, d, kh, kw, *(grid or (0, 0)), 0, scale)
        key = torch.arange(sk, device="cuda")
        valid = key < (n_valid or sk)
        if grid:
            valid &= (key // kw < grid[0]) & (key % kw < grid[1])
        mask = torch.zeros(b, heads, s, sk, device="cuda", dtype=dtype)
        if kh:
            mask = (bh[..., :, None] + bw[..., None, :]).reshape(mask.shape)
        mask = mask.masked_fill(~valid, float("-inf"))
        flops = 4.0 * b * heads * s * sk * d
        print(f"{kernel} shape ({b}, {heads}, {s}, {d}), Kh {kh}, Kw {kw}, "
              f"kv_len {n_valid}, kv_grid {grid}:")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ref_f = ref.float()
        for name, fn in fns.items():
            out = torch.empty_like(ref)
            args = (*c_args(out), int(bf16), stream)

            def run(fn=fn, args=args):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = ((out.float() - ref_f).abs()
                   - rtol * ref_f.abs()).max().item()
            ms = _ms(torch, run, 10)
            rate = flops / (ms * 1e-3) / peak
            print(f"  {name}: gap {gap:.3e} ms {ms:.4f} ({rate:.1%} of "
                  f"{peak / 1e12:.0f} TFLOP/s)")
        lib = _ms(torch, lambda: F.scaled_dot_product_attention(
            *views, attn_mask=mask, scale=scale), 5)
        print(f"  sdpa: ms {lib:.4f}")
        del q, ref, views, mask, bh, bw, kl
        torch.cuda.empty_cache()


# K7's width, hidden width and calls per forward: the Hopper body's (SAM
# ViT-B/16, DINOv2 ViT-B/14) and the C 1536 loop's (DINOv2 ViT-g/14)
_K7_WIDTHS = {"k7": (768, 3072, 12), "k7wide": (1536, 6144, 40)}


def _k7_variants(kernel: str, out_dir: Path) -> None:
    """K7's variants (bf16, the weights in the torch Linear layout): the
    Hopper body at C 768, hidden 3072 (SAM's and DINOv2's rows) or the
    loop at C 1536, hidden 6144 (ViT-g/14's rows): gap to the plain
    version beyond one bf16 step, ms beside the unfused PyTorch path's,
    and the share of the bf16 tensor-core peak (989 TFLOP/s, H100 SXM).
    First the time of the wrapper's two weight casts under `fast` (the
    model's fp32 Linear weights to bf16), one call's and a forward's."""
    import torch
    import torch.nn.functional as F

    from ..ops import mlp_fused as M

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, hidden, per_forward = _K7_WIDTHS[kernel]
    dt, eps = torch.bfloat16, 1e-6

    def rand(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    w1 = rand(hidden, c, s=c ** -0.5, dtype=dt)
    w2 = rand(c, hidden, s=hidden ** -0.5, dtype=dt)
    b1, b2 = rand(hidden, s=0.02), rand(c, s=0.02)
    ln_s, ln_b = 1.0 + rand(c, s=0.1), rand(c, s=0.1)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    # as models/vit.py passes them (first.weight.t(), second.weight.t())
    # and ops/mlp_fused.py casts them
    w1_arg, w2_arg = w1.float().t(), w2.float().t()
    casts = _ms(torch, lambda: (w1_arg.t().to(dt).contiguous(),
                                w2_arg.t().to(dt).contiguous()), 20)
    print(f"{kernel} weight casts fp32 -> bf16 (w1 and w2): ms {casts:.4f} "
          f"a call, {per_forward * casts:.4f} over a forward's "
          f"{per_forward} calls")
    del w1_arg, w2_arg
    for rows, with_ls in CALLS[kernel][1]:
        x = rand(rows, c, dtype=dt)
        ls = 0.1 + rand(c, s=0.02, dtype=dt) if with_ls else None
        ref = M.fused_ln_mlp_residual_plain(x, ln_s, ln_b, w1.t(), b1,
                                            w2.t(), b2, ls, eps=eps).float()
        flops = 4.0 * rows * c * hidden
        print(f"{kernel} rows {rows} x {c}, hidden {hidden}, layerscale "
              f"{with_ls}:")
        for name, fn in fns.items():
            out = torch.empty_like(x)
            args = (*map(ptr, (x, ln_s, ln_b, w1, b1, w2, b2, ls, out)),
                    rows, c, hidden, eps, 1, stream)

            def run(fn=fn, args=args):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = ((out.float() - ref).abs() - 2 ** -7 * ref.abs()).max()
            ms = _ms(torch, run, 10)
            print(f"  {name}: gap {gap.item():.3e} ms {ms:.4f} "
                  f"({flops / (ms * 1e-3) / 989e12:.1%} of 989 TFLOP/s)")
        p = [t.to(dt) for t in (ln_s, ln_b, b1, b2)]

        def unfused():
            y = F.layer_norm(x, (c,), p[0], p[1], eps)
            o = F.linear(F.gelu(F.linear(y, w1, p[2]), approximate="tanh"),
                         w2, p[3])
            return x + (o * ls if with_ls else o)

        print(f"  unfused PyTorch bf16: ms {_ms(torch, unfused, 10):.4f}")
        del x, ref
        torch.cuda.empty_cache()


# K8's shapes: an `int8` forward's five contractions (K, N) at the global
# layers' M 16384 (4 blocks) and the windowed layers' 19712 (8 blocks)
_K8_FORWARD = {16384: 4, 19712: 8}
_K8_KN = {"q": (768, 768), "kv": (768, 1536), "proj": (768, 768),
          "lin1": (768, 3072), "lin2": (3072, 768)}


def _k8_variants(kernel: str, out_dir: Path) -> None:
    """K8's variants at an `int8` forward's ten shapes: exact or not
    (``torch.equal`` against the plain version), ms per shape, and the
    sum over the forward's 60 launches beside ``torch._int_mm``'s and the
    bound's (bytes or int8 operations, H100 SXM: 3.35 TB/s, 1979 TOP/s)."""
    import torch

    from ..ops import quant as Q

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sums = dict.fromkeys([*fns, "int_mm", "bound"], 0.0)
    for m, blocks in _K8_FORWARD.items():
        for label, (k, n) in _K8_KN.items():
            x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            w_kn = w.t().contiguous()
            ref = Q.int8_matmul_plain(x, w_kn)
            bound = max((m * k + n * k + 4 * m * n) / 3.35e12,
                        2.0 * m * k * n / 1979e12) * 1e3
            cells = []
            for name, fn in fns.items():
                out = torch.empty(m, n, dtype=torch.int32, device="cuda")
                args = (ctypes.c_void_p(x.data_ptr()),
                        ctypes.c_void_p(w.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()), m, n, k, stream)

                def run(fn=fn, args=args):
                    rc = fn(*args)
                    if rc:
                        raise RuntimeError(f"variant launch failed: {rc}")

                run()
                torch.cuda.synchronize()
                ms = _ms(torch, run, 20)
                sums[name] += blocks * ms
                cells.append(f"{name} {ms:.4f}"
                             + ("" if torch.equal(out, ref) else " WRONG"))
            lib = _ms(torch, lambda: torch._int_mm(x, w_kn), 20)
            sums["int_mm"] += blocks * lib
            sums["bound"] += blocks * bound
            print(f"{kernel} M={m} {label} {k}x{n}: " + "; ".join(cells)
                  + f"; _int_mm {lib:.4f}; bound {bound:.4f}")
            del x, w, w_kn, ref
        torch.cuda.empty_cache()
    print(f"{kernel} over an int8 forward's 60 launches, ms: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in sums.items()))


_PAIR_CHILD = r'''
import sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.core import precision
from vit_deep_radiomics_tpu_torch.data import synthetic as syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_window_attention", "fused_global_attention"))
m = vit.ViTDense(vit.SAM_VIT_B, policy=precision.FAST).init_random(0)
m = m.cuda().eval()
x = torch.rand(4, 1024, 1024, 3, device="cuda")
with torch.no_grad():
    for _ in range(3):
        m(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        m(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 10
print(f"forward fast B=4, mean of 10: {dt * 1e3:.3f} ms = {4 / dt:.2f} img/s",
      flush=True)
state = m.state_dict()
del m
torch.cuda.empty_cache()
cs.extraction_phase(torch, A, tex, syn, state)
'''

# device time of SAM's and DINOv2's steps (utils/profiling.py), for the
# `fast` and `parity` children
_DEVICE_STEPS = r'''
from vit_deep_radiomics_tpu_torch.utils import profiling
for backbone in ("medsam", "dinov2_vitb14"):
    r = profiling.profile_finetune_step(2, rows=5, precision="{precision}",
                                        backbone=backbone)
    print(f"fine-tune device {{backbone}} {precision} B=2: wall "
          f"{{r['wall_ms']:.3f}} ms, device {{r['device_ms']:.3f}} ms, idle "
          f"{{r['idle_share']:.3f}}; " + "; ".join(
              f"{{x['name'][:28]}} {{x['ms']:.3f}}" for x in r["top"]))
    torch.cuda.empty_cache()
'''

_PAIR_PARITY_CHILD = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.engine import finetune as ft
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(cs.K6_NAMES)
for backbone in ("medsam", "dinov2_vitb14"):
    cs.finetune_phase(torch, A, ft, backbone, "parity",
                      cs.PARITY_STEP_LAUNCHES)
    torch.cuda.empty_cache()
''' + _DEVICE_STEPS.format(precision="parity") + r'''recs = cs.k6_phase(torch, G, cs.peaks_for(torch.cuda.get_device_name(0))[1])
for name, rec in recs.items():
    for shape, r in rec["by_shape"].items():
        print(f"k6 {name} [{shape}]: ms {r['ms']:.4f} bound {r['bound_ms']:.4f}"
              f" sdpa {r['library_ms']:.4f} err {r['max_abs_err']:.3e}")
'''


_PAIR_FAST_CHILD = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.engine import finetune as ft
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_window_attention", "fused_global_attention",
                      "window_attention_bwd", *cs.K5_NAMES))
cs.finetune_phase(torch, A, ft, "medsam", "fast", cs.STEP_LAUNCHES)
torch.cuda.empty_cache()
cs.finetune_phase(torch, A, ft, "dinov2_vitb14", "fast",
                  cs.DINO_FAST_STEP_LAUNCHES)
torch.cuda.empty_cache()
''' + _DEVICE_STEPS.format(precision="fast") + r'''peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
recs = {**cs.train_kernel_phase(torch, A, G, peaks),
        **cs.kv_len_phase(torch, A, G, peaks)}
for name, r in recs.items():
    print(f"k5 {name}: ms {r['ms']:.4f} bound {r['bound_ms']:.4f} "
          f"sdpa {r['library_ms']:.4f} err {r['max_abs_err']:.3e}")
torch.cuda.empty_cache()
# K2 bf16 at phase 3's shapes: its time and its output bits
import hashlib
g = torch.Generator(device="cuda").manual_seed(cs.SEED)
for tag, (b, s, kh, nv) in {"sam": (4, 4096, 64, None),
                            "kv_len": (4, 1536, 0, 1370)}.items():
    q, kv = (torch.randn(b, s, w, generator=g, device="cuda").to(
        torch.bfloat16) for w in (768, 1536))
    bh = bw = kl = None
    if kh:
        bh, bw = ((torch.randn(b, 12, s, kh, generator=g, device="cuda")
                   * 0.3).to(torch.bfloat16) for _ in range(2))
    else:
        kl = torch.full((b,), nv, dtype=torch.int32, device="cuda")
    def k2():
        return A.fused_global_attention(q, kv, bh, bw, kl, num_heads=12,
                                        scale=0.125)
    bits = hashlib.sha256(k2().view(torch.int16).cpu().numpy().tobytes())
    print(f"k5 K2 bf16 [{tag}]: ms {cs.cuda_ms(torch, k2, 20):.4f} sha256 "
          f"{bits.hexdigest()[:16]}")
'''

_PAIR_PARITY_FORWARD_CHILD = r'''
import dataclasses, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.core import precision
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.utils import cuda_build, profiling
cuda_build.build_all(("fused_window_attention", "fused_global_attention",
                      "flash_attention"))
for size in (1024, 768):
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=size)
    m = vit.ViTDense(cfg, policy=precision.PARITY).init_random(0)
    m = m.cuda().eval()
    x = torch.rand(4, size, size, 3, device="cuda")
    with torch.no_grad():
        for _ in range(2):
            m(x)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(5):
            m(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
    n = {k: v // 5 for k, v in A.LAUNCHES.items() if v}
    print(f"forward parity @{size} B=4, mean of 5: {dt * 1e3:.3f} ms = "
          f"{4 / dt:.2f} img/s; launches per forward {n}", flush=True)
    del m, x
    torch.cuda.empty_cache()
    r = profiling.profile_forward(4, "parity", steps=3, rows=6,
                                  image_size=size)
    print(f"forward parity @{size} B=4 device: wall {r['wall_ms']:.3f} ms, "
          f"device {r['device_ms']:.3f} ms, idle {r['idle_share']:.3f}; "
          + "; ".join(f"{x['name'][:28]} {x['ms']:.3f}" for x in r["top"]),
          flush=True)
    torch.cuda.empty_cache()
# the fp32 kv_len shape (DINOv2 @518: 4 x 1536 tokens, 1370 valid)
g = torch.Generator(device="cuda").manual_seed(0)
b, s, h, d, nv = 4, 1536, 12, 64, 1370
kl = torch.full((b,), nv, dtype=torch.int32, device="cuda")
q, kv = (torch.randn(b, s, w, generator=g, device="cuda") for w in (768, 1536))
ms = cs.cuda_ms(torch, lambda: A.fused_global_attention(
    q, kv, None, None, kl, num_heads=h, scale=d ** -0.5), 10)
print(f"kernel fused_global_attention fp32 [kv_len]: ms {ms:.4f}")
q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda")
           for _ in range(3))
ms = cs.cuda_ms(torch, lambda: A.flash_attention(q, k, v, None, None, kl), 10)
print(f"kernel flash_attention fp32 [kv_len]: ms {ms:.4f}")
del q, kv, k, v
torch.cuda.empty_cache()
peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
recs = cs.kernel_phase(torch, A, peaks)
for name, rec in recs.items():
    print(f"kernel {name} [fp32]: ms {rec['fp32']['ms']:.4f} "
          f"bound {rec['fp32']['bound_ms']:.4f} sdpa "
          f"{rec['fp32']['library_ms']:.4f}; bf16 ms {rec['ms']:.4f}")
rec = cs.k3_phase(torch, A, peaks)
for shape, r in rec["by_shape"].items():
    print(f"kernel flash_attention [{shape}]: ms {r['ms']:.4f} bound "
          f"{r['bound_ms']:.4f} sdpa {r['library_ms']:.4f} "
          f"err {r['max_abs_err']:.3e}")
'''

# SAM @768 under `fast` (its global layers on K3 bf16): the B=4 forward's
# host and device ms (utils/profiling.py), then a one-patient extraction as
# chip_smoke.py's phase 18 runs it
_PAIR_FAST768_CHILD = r'''
import dataclasses, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.core import precision
from vit_deep_radiomics_tpu_torch.data import synthetic as syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.utils import cuda_build, profiling
cuda_build.build_all(("fused_window_attention", "fused_global_attention",
                      "flash_attention"))
r = profiling.profile_forward(4, "fast", steps=5, rows=6, image_size=768)
print(f"forward fast @768 B=4: wall {r['wall_ms']:.3f} ms, device "
      f"{r['device_ms']:.3f} ms, idle {r['idle_share']:.3f}; " + "; ".join(
          f"{x['name'][:28]} {x['ms']:.3f}" for x in r["top"]), flush=True)
torch.cuda.empty_cache()
cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=768)
state = vit.ViTDense(cfg, policy=precision.FAST).init_random(0).state_dict()
ex = tex.DenseExtractor(tex.ExtractionConfig(precision="fast",
                                             image_size=768),
                        state_dict=state)
patient = next(iter(syn.synthetic_cohort(n_patients=1, seed=cs.SEED,
                                         height=256, width=256).values()))
warm = syn.synthetic_volume(np.random.default_rng(9), 256, 256, 2,
                            modality="pet")
ex.extract_volume(warm[0], warm[1], "pet")
torch.cuda.synchronize()
t0 = time.perf_counter()
n = 0
for modality in ("ct", "pet"):
    vol, mask, _ = patient[modality]
    n += len(ex.extract_volume(vol, mask, modality)[0])
torch.cuda.synchronize()
dt = time.perf_counter() - t0
print(f"extraction fast @768: 1 patient x (CT, PET), {n} images in "
      f"{dt * 1e3:.1f} ms = {n / dt:.2f} img/s")
'''

# The frozen-backbone paths of K7 and K8: `fast`, `int8` and `fast` with
# VDR_FUSED_MLP=1 SAM ViT-B/16 @1024 forwards at B=4 (host ms, mean of 5
# after two warm-ups; device ms from utils/profiling.py), a one-patient
# extraction of each as chip_smoke.py's phase 18 runs it, then
# chip_smoke.py's kernel phases 16 (K7) and 17 (K8)
_PAIR_FROZEN_CHILD = r'''
import os, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.core import precision
from vit_deep_radiomics_tpu_torch.data import synthetic as syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.utils import cuda_build, profiling
cuda_build.build_all(("fused_window_attention", "fused_global_attention",
                      "fused_ln_mlp_residual", "int8_matmul"))
paths = {"fast": ("fast", {}), "int8": ("int8", {}),
         "fused_mlp": ("fast", {"VDR_FUSED_MLP": "1"})}
state = vit.ViTDense(vit.SAM_VIT_B, policy=precision.FAST).init_random(
    0).state_dict()
x = torch.rand(4, 1024, 1024, 3, device="cuda")
for label, (prec, env) in paths.items():
    os.environ.update(env)
    m = vit.ViTDense(vit.SAM_VIT_B, policy=precision.get_policy(prec))
    m.load_state_dict(state)
    m = m.cuda().eval()
    with torch.no_grad():
        for _ in range(2):
            m(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            m(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
    del m
    torch.cuda.empty_cache()
    r = profiling.profile_forward(4, prec, steps=3, rows=6)
    print(f"forward {label} @1024 B=4: host {dt * 1e3:.3f} ms = "
          f"{4 / dt:.2f} img/s; device {r['device_ms']:.3f} ms, wall "
          f"{r['wall_ms']:.3f}, idle {r['idle_share']:.3f}; " + "; ".join(
              f"{e['name'][:28]} {e['ms']:.3f}" for e in r["top"]),
          flush=True)
    for key in env:
        os.environ.pop(key)
    torch.cuda.empty_cache()
patient = next(iter(syn.synthetic_cohort(n_patients=1, seed=cs.SEED,
                                         height=256, width=256).values()))
for label, (prec, env) in paths.items():
    os.environ.update(env)
    ex = tex.DenseExtractor(tex.ExtractionConfig(precision=prec),
                            state_dict=state)
    warm = syn.synthetic_volume(np.random.default_rng(9), 256, 256, 2,
                                modality="pet")
    ex.extract_volume(warm[0], warm[1], "pet")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for modality in ("ct", "pet"):
        vol, mask, _ = patient[modality]
        n += len(ex.extract_volume(vol, mask, modality)[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"extraction {label}: 1 patient x (CT, PET), {n} images in "
          f"{dt * 1e3:.1f} ms = {n / dt:.2f} img/s", flush=True)
    for key in env:
        os.environ.pop(key)
    del ex
    torch.cuda.empty_cache()
from vit_deep_radiomics_tpu_torch.ops import quant as Q
sku, peaks = cs.peaks_for(torch.cuda.get_device_name(0))
cs.k7_phase(torch, peaks)
cs.k8_phase(torch, Q, peaks, cs.INT8_PEAKS[sku])
'''

_CHILDREN = {"extraction": _PAIR_CHILD, "parity": _PAIR_PARITY_CHILD,
             "fast": _PAIR_FAST_CHILD, "fast-768": _PAIR_FAST768_CHILD,
             "parity-forward": _PAIR_PARITY_FORWARD_CHILD,
             "frozen": _PAIR_FROZEN_CHILD}


def _pair(parent: Path, change: Path, path: str = "extraction") -> None:
    child = _CHILDREN[path]
    keep = ("forward", "extraction", "fine-tune", "k6 ", "k5 ", "kernel ",
            "Traceback")
    for tag, tree in (("parent", parent), ("change", change),
                      ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", child], cwd=tree,
                             capture_output=True, text=True)
        print(f"{tag} ({tree}): rc {res.returncode}")
        for line in (res.stdout + res.stderr).splitlines():
            if line.startswith(keep) or "Error" in line:
                print("  " + line[:400])
        if res.returncode:
            raise RuntimeError(f"{tag} run failed")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("variants", help="kernel variants at the path shapes")
    v.add_argument("kernel", choices=sorted(SOURCES))
    v.add_argument("--out", type=Path,
                   default=Path(__file__).resolve().parents[1] / "_build"
                   / "probe_variants")
    pr = sub.add_parser("pair", help="parent vs change, end to end")
    pr.add_argument("--path", choices=sorted(_CHILDREN),
                    default="extraction")
    pr.add_argument("parent", type=Path)
    pr.add_argument("change", type=Path)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.cmd == "variants":
        if args.kernel == "k4":
            _k4_variants(args.kernel, args.out)
        elif args.kernel.startswith("k7"):
            _k7_variants(args.kernel, args.out)
        elif args.kernel == "k8":
            _k8_variants(args.kernel, args.out)
        elif args.kernel.startswith("k6"):
            _k6_variants(args.kernel, args.out)
        elif args.kernel.startswith("k5"):
            _k5_variants(args.kernel, args.out)
        elif args.kernel.endswith("f32") or args.kernel == "k3":
            _forward_variants(args.kernel, args.out)
        else:
            _variants(args.kernel, args.out)
    else:
        _pair(args.parent.resolve(), args.change.resolve(), args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
