"""Probes of the Hopper kernels K1 (``csrc/fused_window_attention.cu``), K2
(``csrc/fused_global_attention.cu``), K3 (``csrc/flash_attention.cu``), K4
(``csrc/window_attention_bwd.cu``), the K5 forward
(``csrc/global_attention_fwd_lse.cu``; K2's and its Hopper body in
``csrc/global_fwd_hopper.cuh``),
the K5 backward (``csrc/global_attention_bwd_dkv.cu``,
``csrc/global_attention_bwd_dq.cu``), the K6 forward
(``csrc/flash_attention_fwd.cu``), the K6 backward
(``csrc/flash_attention_bwd_dkv.cu``, ``csrc/flash_attention_bwd_dq.cu``;
its bf16 Hopper bodies in ``csrc/flash_trainable_hopper.cuh``), K7
(``csrc/fused_ln_mlp_residual.cu``) and K8 (``csrc/int8_matmul.cu``) on the
GPU.

Two measurements that ``chip_smoke.py`` does not make::

    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k1
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k2
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k3
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k3win
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k4
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k5fwd
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k5dkv
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k5dq
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6dkv
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6dq
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6fwd
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6hdkv
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6hdq
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe variants k6hfwd
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
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path fast-2048 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path finetune-768 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path finetune-640 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path finetune-896 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path finetune-544 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path finetune-576 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path finetune-960 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe gaps [--seeds 10] [--shape sam544_global]
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe sass [--source flash_attention_bwd_dq] [--match hopper_kernel] PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path frozen PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path dinov2 PARENT CHANGE
    python -m vit_deep_radiomics_tpu_torch.utils.kernel_probe pair --path k1 PARENT CHANGE

``variants`` builds copies of one kernel's source with one constant or one
step changed (K1: the number of buffered work items or of consumer
warpgroups, four bias steps of E instead of three; K2: the ring depth or the consumer warpgroups; K3 bf16: 64-key
tiles with the masked columns in bias_w instead of 48-key boxes, two
consumer warpgroups, the ring depth; K4: one
warpgroup, the bias rows read from device memory instead of staged by
bulk copy, the bias gradients' product or the bias tile's build removed, phase A or phase B (the key-major recompute)
removed, phase B's dk/dv products removed; the K5 forward: two consumer
warpgroups, the ring depth, Q^ formed in the shared Q tile instead of in
the A fragments, the bias or the Kw 128 swap of its bias_w registers
removed; the
K5 backward: three consumer warpgroups, the ring depth, the bias step
removed; the K6 backward: one tile buffer instead of two, or 64-column
tiles, a 4 x 8 score micro-tile; the K6 bf16 backward's Hopper bodies
(``k6hdq``, ``k6hdkv``): the ring depth, exp2f instead of ex2.approx.ftz,
dq without the warpgroups' turns or the bias sums, dkv without the bias
add or the bias_w terms' conversion, and dkv's terms at Kw 2 mod 4 staged
row-major four times instead of key-major (``terms_4x``; also at SAM
@544's and @592's global shapes); the K6 bf16 forward's Hopper body
(``k6hfwd``): the ring depth, three consumer warpgroups, dq's two 32-key
passes at Kw 60 and 64, the bias add or the PV product removed; the
register-tiled fp32 forward of K1,
K2, K3 and K6 (``csrc/f32_tiled_forward.cuh``, ``k1f32``, ``k2f32``,
``k3f32`` and ``k6fwd``): 64-key tiles, which make the score micro-tile 4 x
8, two tile buffers, P in a tile of its own, all of K3's grid columns
(and window keys) visited, K3's window mode on the loops, K1's ragged
fourth row block of a window not launched, the bias step removed;
for all the softmax (K5 and K6: the exp2/dS step) or the products
removed, and for K5, K6 and the fp32 forward the score (and dP)
products removed; K7's Hopper body: two ring slots a warpgroup, the
hardware tanh in the GELU, the GELU or either product removed; K7's C
1536 cluster body (``k7wide``): no multicast (each block loads the whole
y slice itself), 64-row tiles (one warpgroup a block: each weight byte
read once per 64 rows), two ring slots, and the loops' 32-row instance
(and its 16-row blocks) that the body replaced; K8: the
ring depth: timing ablations
whose output is wrong by design where a step is removed),
calls each through ``ctypes`` at its path's shapes (K1: q (100, 196, 768),
Kh = Kw = 14, and 16 x 16 windows, q (100, 256, 768), each variant's
output also as a SHA-256; K2: q (4, 4096, 768), Kh = Kw = 64, and DINOv2's kv_len
shape, 4 x 1536 with 1370 valid; K3 bf16: SAM @768's q (4, 12, 2304, 64)
and JAX's padded (4, 12, 3072, 64) against k/v (4, 12, 3072, 64), Kh 48,
Kw 64, ``kv_grid`` (48, 48); K3's window mode in bf16 (``k3win``): q (25,
12, 1024, 64), 100 windows of 16 x 16 tokens with 14 x 14 valid, beside
SDPA on one batch entry a window; K4: q (50, 196, 768), Kh = Kw = 14; K5:
q (2, 4096, 768), Kh = Kw = 64, and the kv_len shape at B=2, bf16, both
also q (1, 4096, 768) on a key grid of 32 x 128 and the forward q (1,
16384, 768) on 128 x 128 (SAM @2048's), the forward's out and lse held to
its plain version (two heads a call); K6: the
`parity` path's SAM global (2, 12, 4096, 64), Kh = Kw = 64, and windowed
(50, 12, 196, 64), Kh = Kw = 14, fp32 (the forward also DINOv2's (2, 12,
1536, 64) with 1370 valid keys); the K6 bf16 Hopper bodies: SAM @768's (2,
12, 2304, 64), Kh = Kw = 48, @640's (2, 12, 1600, 64), Kw 40, @896's (2,
12, 3136, 64), Kw 56, @576's, @832's and @960's and DINOv2's kv_len
shape, beside the whole bf16 SDPA backward (the forward's beside SDPA's
forward); K1 fp32: q (100, 196, 768), Kh = Kw =
14; K2 fp32: q (4, 4096, 768), Kh = Kw = 64, and DINOv2's kv_len shape;
K3 fp32: SAM @768's q (4, 12, 2304, 64), k/v 3072 rows, Kh 48, Kw 64,
``kv_grid`` (48, 48), (4, 12, 1536, 64) with 1370 valid keys, and the
``k3win`` window shape (its ``loops`` variant: window mode on the loops
that took it before the tiled body); K7:
SAM's 16384 rows and DINOv2's 4 x 1370 with a layerscale, C 768, hidden
3072, bf16; ``k7wide``: ViT-g/14's 4 x 1370 with a layerscale, C 1536,
hidden 6144, bf16; K8: an `int8` forward's ten shapes, with the sum over its 60
launches), and prints its gap to the
plain version and its time (K1/K2 and the fp32 forward beside SDPA's, K4
and K5 and the K6 bf16 backward beside the bf16 tensor-core peak, K6 in
fp32 beside the fp32 CUDA cores' peak).
A variant that changes a header (the fp32 forward's steps, the K6 bf16
backward's constants) builds from its own directory, which holds the
changed copy.
``gaps`` reads each K6 bf16 output's distance to the fp64 oracle of its
rounding points (``k6_oracle_gaps``) over seeds at every bf16 shape of
``chip_smoke.py``'s phase 10, for the backward body the tree's route
takes there, beside the plain versions' distance; one JSON line a shape
and seed (``tests/k6_bf16_shim.py`` reads the same on the CPU).
``sass`` builds kernel sources (default: the K6 forward's and backward's
three) in two checkouts and says, kernel by kernel (``--match``, default
the Hopper bodies), whether ``cuobjdump -sass`` lists the same code in
both, and which kernels one tree alone builds; it prints names and the
first differing lines only, never whole listings.
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
and @768 (K3 fp32) on the host clock, each after a warm-up, with a SHA-256
of each forward's output, and their
device ms (``utils/profiling.py``), then K2 and K3
in fp32 at DINOv2's kv_len shape, K3 in fp32 at the @768 path's shape (ms
and a SHA-256 of its output), and
``chip_smoke.py``'s kernel phases 3 and 15; with ``--path fast-768`` the
`fast` SAM @768 forward at B=4 (host and device ms, ``utils/profiling.py``)
and a one-patient @768 extraction as ``chip_smoke.py``'s phase 18 runs it;
with ``--path fast-2048`` a SAM ViT-B/16 @2048 `fast` fine-tuning step at
B=1 (``FineTuner`` with ``backbone_cfg``; wall ms, device ms, idle share
and the top device costs from ``utils/profiling.py``'s ``trace_runs``),
the three K5 kernels' ms on key grids 128 keys wide (B=1, Kh 32 and Kh
128: SAM @2048's global layers), and a SHA-256 of the K5 dq and dkv
outputs at SAM @1024's Kw 64 shape and DINOv2's kv_len shape (no bias),
which must not differ between the trees; with ``--path finetune-768``
``chip_smoke.py``'s phase 24 (SAM ViT-B/16 @768 `fast` fine-tuning at B=2,
its global layers on K6 in bf16: step ms, launches, then wall ms, device
ms, idle share and the top device costs from ``trace_runs``), the three K6
kernels' ms in bf16 and the whole bf16 SDPA backward's at ``chip_smoke.py``'s
``K6_BF16_SHAPES`` (its global layers' shape (2, 12, 2304, 64), Kh = Kw =
48, and DINOv2's kv_len shape (2, 12, 1536, 64), 1370 valid), SDPA's
forward and SHA-256s of the forward's outputs (out, lse) and of the
backward's (dq, both bias gradients, dk, dv): a hash may differ between
the trees only where a tree's route gives the forward or the backward
another body (its sums run in another order), and the backward's then
also where only the forward's body changed (it is fed that forward's lse
and D); what parent and change are held to there is each tree's phase 24
(launches, each kernel against its plain version) and the times; with
``--path finetune-544``, ``finetune-576``, ``finetune-640``,
``finetune-896`` or ``finetune-960`` the same for SAM ViT-B/16 `fast`
fine-tuning at that size (B=2, 5 steps held to the launches of the
bodies each tree's routes name at its 34 x 34, 36 x 36, 40 x 40, 56 x 56
or 60 x 60 global grid, traced steps), then the three K6 bf16 kernels' ms
at that grid (``finetune-960``: also at @704's and @832's, 44 x 44 and 52
x 52; ``finetune-544``: also at @592's 37 x 37, the mma.sync bodies' main
path) beside the bf16 SDPA forward's and whole backward's and SHA-256s of
their outputs;
with ``--path frozen`` the `fast`, `int8` (K8) and ``VDR_FUSED_MLP=1`` (K7)
SAM @1024 forwards at B=4 (host ms, device ms from ``utils/profiling.py``),
a one-patient extraction of each, and ``chip_smoke.py``'s kernel phases 16
and 17 (K7 and K8); with ``--path dinov2`` ``chip_smoke.py``'s phase 16
(K7, ViT-g/14's rows among them) and its phase 19 for ViT-g/14 ``full``
@518 with ``VDR_FUSED_MLP=1`` alone (the B=4 forward's host ms, device
ms, idle share and top device costs, the batch-1 checks and a one-patient
extraction's img/s); with ``--path k1`` K1 in bf16 through its wrapper at
SAM's 14 x 14 windows and at 16 x 16 windows (100 windows, 12 heads, one
a batch row): its route, ms and a SHA-256 of its output, which must not
differ between the trees.
Nothing is built or run at import.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

__all__ = ["SOURCES", "HEADERS", "VARIANTS", "CALLS", "variant_source",
           "variant_files", "main"]

SOURCES = {"k1": "fused_window_attention.cu",
           "k1f32": "fused_window_attention.cu",
           "k3": "flash_attention.cu",
           "k3win": "flash_attention.cu",
           "k2": "fused_global_attention.cu",
           "k4": "window_attention_bwd.cu",
           "k6fwd": "flash_attention_fwd.cu",
           "k5fwd": "global_attention_fwd_lse.cu",
           "k6dkv": "flash_attention_bwd_dkv.cu",
           "k6dq": "flash_attention_bwd_dq.cu",
           "k6hdkv": "flash_attention_bwd_dkv.cu",
           "k6hdq": "flash_attention_bwd_dq.cu",
           "k6hfwd": "flash_attention_fwd.cu",
           "k5dkv": "global_attention_bwd_dkv.cu",
           "k5dq": "global_attention_bwd_dq.cu",
           "k2f32": "fused_global_attention.cu",
           "k3f32": "flash_attention.cu",
           "k7": "fused_ln_mlp_residual.cu",
           "k7wide": "fused_ln_mlp_residual.cu",
           "k8": "int8_matmul.cu"}
# headers a variant of the kernel may change (copied beside its source)
HEADERS = {"k1": ("window_hopper.cuh",),
           "k3win": ("window_hopper.cuh",),
           "k2": ("global_fwd_hopper.cuh",),
           "k5fwd": ("global_fwd_hopper.cuh",),
           "k1f32": ("f32_tiled_forward.cuh",),
           "k2f32": ("f32_tiled_forward.cuh",),
           "k3f32": ("f32_tiled_forward.cuh",),
           "k6fwd": ("f32_tiled_forward.cuh",),
           "k6hdkv": ("flash_trainable_hopper.cuh", "attention_bwd_core.cuh",
                      "flash_trainable_bf16.cuh"),
           "k6hdq": ("flash_trainable_hopper.cuh", "flash_trainable_bf16.cuh"),
           "k6hfwd": ("flash_trainable_hopper.cuh",
                      "flash_trainable_bf16.cuh")}
# entry points other than vdr_<source>: K6's bf16 builds
ENTRIES = {"k6hdkv": "vdr_flash_attention_bwd_dkv_bf16",
           "k6hdq": "vdr_flash_attention_bwd_dq_bf16",
           "k6hfwd": "vdr_flash_attention_fwd_bf16"}
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
# K7 at C 1536 routed to the loops instead of the cluster body
_K7_LOOPS = ("return dtype == 1 && C == kCC && H > 0 && H % kChunkC == 0;",
             "return false;")
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
    # K7's cluster body at C 1536 (DINOv2 ViT-g/14): no multicast (each
    # block loads all four quarters of the tile's y slice: 4x the y reads
    # from L2), 64-row tiles (one warpgroup a block: each weight byte read
    # once per 64 rows, not 128), two ring slots instead of three; for
    # reference the loops' 32-row instance that the body replaced and its
    # 16-row blocks (the route sends C 1536 to the loops)
    "k7wide": {
        "as_built": ({}, ()),
        "no_multicast": ({"kMulticast": 0}, ()),
        "rows_64": ({"kWgsC": 1}, ()),
        "stages_2": ({"kStagesC": 2}, ()),
        # a producer refills only once the barrier it waits for is not
        # complete (the ring may run dry before it does)
        "refill_when_stalled": ({}, ((
            "        pump();\n        if (mbar_test(bar, parity)) break;",
            "        if (mbar_test(bar, parity)) break;\n        pump();"),)),
        "loops": ({}, (_K7_LOOPS,)),
        "loops_rows_16": ({"kRowsG": 16}, (_K7_LOOPS,)),
    },
    # K8: the ring depth
    "k8": {
        "as_built": ({}, ()),
        "stages_2": ({"kStages": 2}, ()),
        "stages_3": ({"kStages": 3}, ()),
        "stages_4": ({"kStages": 4}, ()),
    },
    # K1's Hopper body (bf16): one buffered item (at 16 x 16 windows with
    # the bias rows staged), one consumer warpgroup, four bias steps of E
    # instead of three, the softmax or the products removed
    "k1": {
        "as_built": ({}, ()),
        "buffers_1": ({"kBuffers": 1}, ()),
        "bias_steps_4": ({"kBiasSteps": 4}, ()),
        "consumers_1": ({"kConsumers": 1}, ()),
        "no_softmax": ({}, ("softmax_rows<N>(s, pa, p.scale_log2, l_lo, "
                            "l_hi);",)),
        "no_products": ({}, (
            "qk_products<N>(s, frag, q_addr, k_addr, e_addr);",
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
    # K3's window mode on K1's whole-window body (bf16): every key of the
    # window in N (256, not 224 at SAM's 16 x 16 windows with 14 x 14
    # valid), one buffered item (the bias rows staged) instead of two (the
    # bias rows read from device memory), four bias steps of E instead of
    # three, the bias wgmma or the softmax removed, and the loops that took
    # window mode before
    "k3win": {
        "as_built": ({}, ()),
        "keys_256": ({"kWinCutRows": 0}, ()),
        "buffers_1": ({"kBuffers": 1}, ()),
        "bias_steps_4": ({"kBiasSteps": 4}, ()),
        "no_bias": ({}, ((
            "    Wgmma<N>::template rs<0>(s, a[0], de + 2 * kb, 1);",
            "    ;"),)),
        "no_softmax": ({}, ("softmax_rows<N>(s, pa, p.scale_log2, l_lo, "
                            "l_hi);",)),
        "loops": ({}, (("    return launch_window(p, wp, n, smem, s);",
                        "    ;"),)),
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
    # tile; the bias (the no-bias instance on the same operands) or, at
    # Kw 128, the swap of the bias_w register set removed; the softmax or
    # the products removed
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
        "no_bias": ({}, (("static_cast<const __nv_bfloat16*>(bias_h),",
                          "nullptr,"),)),
        "no_swap": ({}, ("if (n_even < n_tiles) load_bw(0, 64);",)),
        "no_softmax": ({}, ("probs(0);", "probs(j);")),
        "no_products": ({}, (
            "qk_tile<kBK>(s, qa, k_addr);",
            "qk_tile<kBK>(s, qa, k_addr + cur * kTile);",
            "pv_tile<kBK>(o, pa, v_addr + prev * kTile);",
            "pv_tile<kBK>(o, pa, v_addr + last * kTile);")),
    },
    # K6's bf16 backward on its Hopper bodies (flash_trainable_hopper.cuh):
    # the ring depth, the warpgroups' turns in issuing their products, the
    # bias gradients (dq) or the bias terms (dkv), the exponentials or
    # either product removed
    "k6hdq": {
        "as_built": ({}, ()),
        "stages_4": ({"kHopperDqStages": 4}, ()),
        "stages_8": ({"kHopperDqStages": 8}, ()),
        "no_pingpong": ({}, (
            ("auto issue_wait = [&] { bar_sync(my_bar, 256); };",
             "auto issue_wait = [&] {};"),
            ("auto issue_done = [&] { bar_arrive(next_bar, 256); };",
             "auto issue_done = [&] {};"))),
        "no_bias_grads": ({}, (
            "dbw[i] += ds;",
            "if (dbh_lo != nullptr) dbh_lo[r] = kU ? dbh_lo[r] + lo : lo;",
            "if (dbh_hi != nullptr) dbh_hi[r] = kU ? dbh_hi[r] + hi : hi;")),
        # exp2f (ex2.approx with subnormal handling) for ex2.approx.ftz
        "exp2f": ({}, (("? fast_exp2(s[i] - ((i & 2) ? l_hi : l_lo))",
                        "? exp2f(s[i] - ((i & 2) ? l_hi : l_lo))"),)),
        "no_softmax": ({}, (("? fast_exp2(s[i] - ((i & 2) ? l_hi : l_lo))",
                             "? (s[i] - ((i & 2) ? l_hi : l_lo))"),)),
        "no_products": ({}, ("pv_tile<kNK>(dq, da, k_of(j - 1));",
                             "pv_tile<kNK>(dq, da, k_of(n_tiles - 1));")),
        "no_scores": ({}, (
            "dq_scores<kNK>(s, dp, q_addr, do_addr, ring, ring + kKTile);",
            "dq_scores<kNK>(s, dp, q_addr, do_addr, cur, cur + kKTile);")),
    },
    # K6's bf16 forward on its Hopper body: the ring depth, the consumer
    # warpgroups, dq's tiling (two 32-key passes at Kw 60 and 64, where the
    # forward takes one of 64), the bias add or the PV product removed
    "k6hfwd": {
        "as_built": ({}, ()),
        "stages_4": ({"kHopperFwdStages": 4}, ()),
        "stages_8": ({"kHopperFwdStages": 8}, ()),
        "consumers_3": ({"kHopperFwdConsumers": 3}, ()),
        "dq_tiles": ({"kHopperFwdOnePass": 56}, ()),
        "no_bias": ({}, ((
            "} else if (add) {\n      const float th_lo = bh_s[r * "
            "kFwdBiasLd + r_lo];",
            "} else if (false) {\n      const float th_lo = bh_s[r * "
            "kFwdBiasLd + r_lo];"),)),
        "no_products": ({}, ("pv_tile<kNK>(o, pa, k_of(j - 1) + kKTile);",
                             "pv_tile<kNK>(o, pa, k_of(n_tiles - 1) + "
                             "kKTile);")),
    },
    # dkv: also, at Kw 2 mod 4, the bias_w terms staged row-major four
    # times instead of key-major
    "k6hdkv": {
        "as_built": ({}, ()),
        "stages_3": ({"kHopperDkvMaxStages": 3}, ()),
        "terms_4x": ({"kHopperTermsKeyMajor": 0}, ()),
        "no_bias": ({}, ("add_bias<kTermLd>(s, sm + 128, stage_at(j) + "
                         "kTermOff, hr_lo, hr_hi,\n                        "
                         "col_lo, col_hi, lane, c);",
                         "add_bias_key_major(s, sm + 128, stage_at(j) + "
                         "kTermOff + term_lane,\n                         "
                         "hr_lo, hr_hi, c);")),
        "no_terms": ({}, (("k < 16 * kKw;", "k < 0;"),
                          ("i < 16 * kKw;", "i < 0;"),
                          ("k < 32 * kKw;", "k < 0;"))),
        "exp2f": ({}, (("sm90::fast_exp2(s[4 * i + e] - ((e & 1) ? l.y : "
                        "l.x))", "exp2f(s[4 * i + e] - ((e & 1) ? l.y : "
                        "l.x))"),)),
        "no_softmax": ({}, (("sm90::fast_exp2(s[4 * i + e] - ((e & 1) ? l.y "
                             ": l.x))",
                             "(s[4 * i + e] - ((e & 1) ? l.y : l.x))"),)),
        "no_products": ({}, ("k5h::product_rs(dv, pa, prev + kTile);",
                             "k5h::product_rs(dk, sa, prev);",
                             "k5h::product_rs(dv, pa, last + kTile);",
                             "k5h::product_rs(dk, sa, last);")),
        "no_scores": ({}, ("k5h::product_ss(s, k_tile, cur + 2 * kTile);",
                           "k5h::product_ss(dp, v_tile, cur + kTile);")),
    },
    "k5dkv": {
        "as_built": ({}, ()),
        "consumers_3": ({"kConsumers": 3}, ()),
        "stages_3": ({"kStages": 3}, ()),
        "stages_5": ({"kStages": 5}, ()),
        "no_bias": ({}, ("add_bias(s, sm + 128 + 64 * wg, bw_tile, warp, "
                         "lane, c);",)),
        "no_softmax": ({}, ("vdr::k5h::probs_ds(s, dp, sm, sm + 64, c, "
                            "ragged, lo_ok, hi_ok);",)),
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
                         "bias_grads<kHalves>(dp, dbw, dbh_lo, dbh_hi, kr, "
                         "c,\n                            dbh_s + kr * "
                         "kBiasLd + r_lo, kt, n_tiles);")),
        "no_softmax": ({}, ("probs_ds(s, dp, l_lo, l_hi, d_lo, d_hi, ragged, "
                            "kt * 64 + 2 * c,\n               n_keys);",)),
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
    # K3 also: every column of a padded key grid (and of a window) visited,
    # the masked ones scored at -1e30, instead of the valid ones alone; and
    # window mode on the loops that took it before (the global shapes stay
    # on the tiled body there)
    "k3f32": {**_F32_TILED, "all_cols": ({"kF32SkipCols": 0}, ()),
              "loops": ({"kF32WindowTiled": 0}, ())},
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
# the K5 kernels (bf16): SAM @1024's global layers, DINOv2's kv_len and
# key grids 128 keys wide (chip_smoke.py's KW128, B=1, Kh 32: SAM @2048's
# rows of 128 keys at a quarter of its grid rows; the forward also SAM
# @2048's global layers, Kh 128, whose plain backward would not fit)
_K5_SHAPES = ((2, 4096, 64, 64, None), (2, 1536, 0, 0, 1370),
              (1, 4096, 32, 128, None), (1, 16384, 128, 128, None))
_K5_BWD_SHAPES = _K5_SHAPES[:3]
_K6H_SHAPES = ((2, 2304, 48, 48, None), (2, 1600, 40, 40, None),
               (2, 3136, 56, 56, None), (2, 1536, 0, 0, 1370),
               (2, 1296, 36, 36, None), (2, 2704, 52, 52, None),
               (2, 3600, 60, 60, None), (2, 1156, 34, 34, None),
               (2, 1369, 37, 37, None))
CALLS = {
    # K1 one window a batch row: SAM's 14 x 14 windows and 16 x 16 ones
    "k1": ([_P] * 5 + [_I] * 7 + [_F, _I, _P],
           ((100, 196, 14, 14, None), (100, 256, 16, 16, None)), _k1_call),
    "k2": ([_P] * 6 + [_I] * 6 + [_F, _I, _P],
           ((4, 4096, 64, 64, None), (4, 1536, 0, 0, 1370)), _k2_call),
    "k4": ([_P] * 10 + [_I] * 7 + [_F, _P], ((50, 196, 14, 14, None),), None),
    "k6fwd": ([_P] * 8 + [_I] * 6 + [_F, _P],
              (*_K6_SHAPES, (2, 1536, 0, 0, 1370)), None),
    "k6dkv": ([_P] * 11 + [_I] * 6 + [_F, _P], _K6_SHAPES, None),
    "k6dq": ([_P] * 12 + [_I] * 6 + [_F, _P], _K6_SHAPES, None),
    # K6's bf16 backward and forward: SAM's global layers at 768, 640,
    # 896, 576, 832, 960, 544 and 592 px and DINOv2's kv_len shape (the
    # last pointer, where the entry writes the body it ran, null; @544 the
    # forward, @592 all three on the mma.sync bodies, which no variant
    # changes)
    "k6hdkv": ([_P] * 11 + [_I] * 6 + [_F, _P, _P], _K6H_SHAPES, None),
    "k6hdq": ([_P] * 12 + [_I] * 6 + [_F, _P, _P], _K6H_SHAPES, None),
    "k6hfwd": ([_P] * 8 + [_I] * 6 + [_F, _P, _P], _K6H_SHAPES, None),
    "k5fwd": ([_P] * 7 + [_I] * 6 + [_F, _P], _K5_SHAPES, None),
    "k5dkv": ([_P] * 9 + [_I] * 6 + [_F, _P], _K5_BWD_SHAPES, None),
    "k5dq": ([_P] * 11 + [_I] * 6 + [_F, _P], _K5_BWD_SHAPES, None),
    # K3 (head-major; S the query rows, Sk = Kh·Kw or S): SAM @768's 48 x
    # 48 grid padded to 48 x 64 with kv_grid (Kh, Kh), against the 2304
    # query rows the path passes and the 3072 JAX pads them to
    "k3": ([_P] * 7 + [_I] * 10 + [_F, _I, _P],
           ((4, 2304, 48, 64, None), (4, 3072, 48, 64, None)), None),
    # K3's window mode: (B, S, Kh, Kw, kv_len, kv_grid, window_tokens),
    # chip_smoke phase 15's `window` shape (100 windows of 16 x 16, 14 x 14
    # valid)
    "k3win": ([_P] * 7 + [_I] * 10 + [_F, _I, _P],
              ((25, 1024, 16, 16, None, (14, 14), 256),), None),
    # fp32: (B, S, Kh, Kw, kv_len); K1 one window a batch row
    "k1f32": ([_P] * 5 + [_I] * 7 + [_F, _I, _P], ((100, 196, 14, 14, None),),
              None),
    "k2f32": ([_P] * 6 + [_I] * 6 + [_F, _I, _P],
              ((4, 4096, 64, 64, None), (4, 1536, 0, 0, 1370)), None),
    "k3f32": ([_P] * 7 + [_I] * 10 + [_F, _I, _P],
              ((4, 2304, 48, 64, None), (4, 1536, 0, 0, 1370),
               (25, 1024, 16, 16, None, (14, 14), 256)), None),
    # K7 (rows, with a layerscale): SAM's 4 x 4096 rows, DINOv2's 4 x 1370
    "k7": ([_P] * 10 + [_I] * 3 + [_F, _I, _P],
           ((16384, False), (5480, True)), None),
    "k7wide": ([_P] * 10 + [_I] * 3 + [_F, _I, _P],
               ((5480, True), (1370, True)), None),
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
    for const, value in consts.items():
        # in the source, else in the one header that defines it
        pattern = rf"constexpr int {const} = \d+;"
        hits = [f for f, body in files.items() if re.search(pattern, body)]
        where = src if src in hits else hits[0] if len(hits) == 1 else None
        if where is None:
            raise ValueError(f"no single constexpr {const} in {hits}")
        files[where] = variant_source(files[where], {const: value})
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
    entry = ENTRIES.get(kernel, "vdr_" + SOURCES[kernel][:-3])
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
            sha = hashlib.sha256(out.view(torch.int16).cpu().numpy()
                                 .tobytes()).hexdigest()[:16]
            print(f"  {name}: gap {gap.item():.3e} ms {_ms(torch, run):.4f}"
                  f" sha256 {sha}")
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


def _sdpa_bwd_ms(torch, q, k, v, mask, scale, dout, mask_grad):
    """The whole SDPA backward (memory-efficient backend) on a retained
    graph, the mask a trainable ``attn_mask`` when ``mask_grad``: ms."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    m = mask.detach().requires_grad_(mask_grad)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(*leaves, attn_mask=m,
                                             scale=scale)
        wrt = leaves + ([m] if mask_grad else [])
        return _ms(torch, lambda: torch.autograd.grad(out, wrt, dout,
                                                      retain_graph=True), 5)


def _k6_variants(kernel: str, out_dir: Path) -> None:
    """The K6 forward's or backward's variants (per-head (B, H, S, D)):
    fp32 (k6fwd, k6dq, k6dkv) at the `parity` path's shapes, ms and share of
    the fp32 CUDA-core peak (67 TFLOP/s, H100 SXM) on the keys scored; the
    bf16 Hopper bodies (k6hfwd, k6hdq, k6hdkv) at SAM @768's, @640's,
    @896's, @576's, @832's and @960's global and DINOv2's kv_len shapes,
    ms and share of the bf16 tensor-core peak (989 TFLOP/s) beside the
    bf16 SDPA forward's (k6hfwd) or whole backward's ms. Each with its
    largest gap to the plain version."""
    import torch

    from ..ops import attention_grad as G

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    scale = d ** -0.5
    bf16 = kernel.startswith("k6h")
    dt, peak = (torch.bfloat16, 989e12) if bf16 else (torch.float32, 67e12)
    which = kernel.replace("k6h", "k6")

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, n_valid in CALLS[kernel][1]:
        q, k, v, dout = (torch.randn(b, heads, s, d, generator=gen,
                                     device="cuda").to(dt) for _ in range(4))
        bh = bw = kl = None
        if kh:
            bh, bw = (torch.randn(b, heads, s, n, generator=gen,
                                  device="cuda") * 0.3 for n in (kh, kw))
        if n_valid:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        pairs = b * heads * s * (n_valid or s) * d
        if which == "k6fwd":
            args = (q, k, v, bh, bw, kl)
            ref = G.flash_attention_fwd_plain(*args, scale=scale)
            flops = 4.0 * pairs
        else:
            out, lse = G.flash_attention_fwd(q, k, v, bh, bw, kl, scale=scale)
            args = (q, k, v, bh, bw, kl, dout, lse,
                    G.flash_attention_delta(out, dout))
            del out
        if which == "k6dq":
            ref = G.flash_attention_bwd_dq_plain(*args, scale=scale)
            flops = 6.0 * pairs
        elif which == "k6dkv":
            ref = G.flash_attention_bwd_dkv_plain(*args, scale=scale)
            flops = 8.0 * pairs
        print(f"{kernel} shape ({b}, {heads}, {s}, {d}), Kh {kh}, Kw {kw}, "
              f"kv_len {n_valid}:")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, fn in fns.items():
            outs = [None if r is None else torch.empty_like(r) for r in ref]
            c_args = (*map(ptr, (*args, *outs)), b, heads, s, d, kh, kw,
                      scale, stream, *((ptr(None),) if bf16 else ()))

            def run(fn=fn, c_args=c_args):
                rc = fn(*c_args)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, ref) if r is not None)
            ms = _ms(torch, run, 10)
            print(f"  {name}: gap {gap:.3e} ms {ms:.4f} "
                  f"({flops / (ms * 1e-3) / peak:.1%} of "
                  f"{peak / 1e12:.0f} TFLOP/s)")
        if bf16:
            if kh:
                mask = (bh[..., :, None] + bw[..., None, :]).reshape(
                    b, heads, s, s).to(dt)
            else:
                key = torch.arange(s, device="cuda")
                mask = torch.zeros(b, heads, s, s, device="cuda",
                                   dtype=dt).masked_fill(key >= n_valid,
                                                         float("-inf"))
            if which == "k6fwd":
                import torch.nn.functional as F
                from torch.nn.attention import SDPBackend, sdpa_kernel

                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    lib = _ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale), 10)
                print(f"  sdpa forward: ms {lib:.4f}")
            else:
                lib = _sdpa_bwd_ms(torch, q, k, v, mask, scale, dout,
                                   bool(kh))
                print(f"  sdpa backward: ms {lib:.4f}")
            del mask
        del q, k, v, dout, bh, bw, kl, args, ref
        torch.cuda.empty_cache()


K6_LABELS = ("out", "lse", "dq", "dbias_h", "dbias_w", "dk", "dv")


def tiled_forward_oracle(torch, G, q, k, v, bh, bw, kl, scale, cols=64):
    """K6's forward out in fp64 at the mma.sync body's own rounding points:
    the online softmax over ``cols``-key tiles, P rounded to bf16 against
    the running max of the tiles so far (as JAX's kernel rounds it per key
    block), every sum unrounded."""
    s = G._flash_scores(q, k, bh, bw, kl, scale, torch.float64)
    vv = v.double()
    m = torch.full(s.shape[:-1] + (1,), -2e30, dtype=torch.float64,
                   device=s.device)
    o = torch.zeros(s.shape[:-1] + (vv.shape[-1],), dtype=torch.float64,
                    device=s.device)
    l = torch.zeros_like(m)
    for k0 in range(0, s.shape[-1], cols):
        st = s[..., k0:k0 + cols]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        a, p = torch.exp2(m - mn), torch.exp2(st - mn)
        o = o * a + p.to(torch.bfloat16).double() @ vv[..., k0:k0 + cols, :]
        l, m = l * a + p.sum(-1, keepdim=True), mn
    return o / l


def oracle_gap(torch, x, oracle, rtol):
    """x's distance to the oracle: {"beyond": max |x - o| beyond rtol·|o|,
    "steps": the largest |x - o| in bf16 steps of the element among
    elements of at least 1/64 of the largest |o|, "rms": the root mean
    square of x - o in bf16 steps of the largest |o|, "off": the share of
    elements more than one bf16 step of the element from o}. "steps" is
    one element's reading and "rms" and "off" read every element."""
    x, o = x.double(), oracle.double()
    err = (x - o).abs()
    top = o.abs().max()
    big = o.abs() >= top / 64
    ulp = torch.exp2(torch.floor(torch.log2(o.abs().clamp_min(1e-30))) - 7)
    return {"beyond": (err - rtol * o.abs()).max().item(),
            "steps": (err / ulp)[big].max().item(),
            "rms": (err.square().mean().sqrt() / (2.0 ** -8 * top)).item(),
            "off": (err > ulp).double().mean().item()}


class _TensorCoreTorch:
    """``torch`` whose ``matmul`` runs on the tensor cores: the operands,
    which hold bf16 values in fp32 in the plain K6 versions, rounded to
    bf16 (exactly, checked) and multiplied with fp32 sums and output
    (``torch.bmm(..., out_dtype=torch.float32)``), as the K6 kernels'
    ``mma.sync`` and ``wgmma`` products sum; every other attribute is
    torch's own."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def matmul(self, a, b):
        torch = self._torch
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if not (torch.equal(a16.to(a.dtype), a)
                and torch.equal(b16.to(b.dtype), b)):
            raise ValueError("a K6 product operand holds no bf16 values")
        out = torch.bmm(a16.reshape(-1, *a.shape[-2:]),
                        b16.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])


def k6_oracle_gaps(torch, G, args, dout, fwd, bwd, scale,
                   tensor_cores=False):
    """{output: {"kernel": gap, "plain": gap, "kernel_vs_plain_steps": x}}:
    the kernels' outputs (fwd: out, lse; bwd: dq, dbias_h, dbias_w, dk, dv,
    with the forward's lse and D) and the plain versions' against the fp64
    oracle of their rounding points (the plain versions with
    ``acc=torch.float64``), each gap ``oracle_gap``'s, and the
    kernel's gap to the plain version beyond one bf16 step of the element
    in bf16 steps of the plain version's largest |value| (what ``chip_smoke.py``'s
    phase 10 limits count); "out_tiled" holds the forward's out against
    ``tiled_forward_oracle``, the oracle of its own 64-key tiles. With
    ``tensor_cores`` each backward output also has "plain_tc", the plain
    version's gap with its products on the tensor cores
    (``_TensorCoreTorch``), and "kernel_vs_plain_tc_steps"."""
    rest = (dout, fwd[1], G.flash_attention_delta(fwd[0], dout))
    plain = (*G.flash_attention_fwd_plain(*args, scale=scale),
             *G.flash_attention_bwd_dq_plain(*args, *rest, scale=scale),
             *G.flash_attention_bwd_dkv_plain(*args, *rest, scale=scale))
    tc = (None, None)
    if tensor_cores:
        G.torch = _TensorCoreTorch(torch)
        try:
            tc += (*G.flash_attention_bwd_dq_plain(*args, *rest, scale=scale),
                   *G.flash_attention_bwd_dkv_plain(*args, *rest,
                                                    scale=scale))
        finally:
            G.torch = torch
    else:
        tc += (None,) * 5
    wide = dict(scale=scale, acc=torch.float64)
    oracle = (*G.flash_attention_fwd_plain(*args, **wide),
              *G.flash_attention_bwd_dq_plain(*args, *rest, **wide),
              *G.flash_attention_bwd_dkv_plain(*args, *rest, **wide))
    res = {}
    for label, x, pl, t, o in zip(K6_LABELS, (*fwd, *bwd), plain, tc,
                                  oracle):
        if o is None:
            continue
        rtol = 0.0 if label in ("lse", "dbias_h", "dbias_w") else 2.0 ** -7
        # and the kernel against the plain version, in bf16 steps of the
        # plain version's largest |value| (phase 10's rule)
        top = pl.float().abs().max().item()
        res[label] = {"kernel": oracle_gap(torch, x, o, rtol),
                      "plain": oracle_gap(torch, pl, o, rtol),
                      "kernel_vs_plain_steps": oracle_gap(
                          torch, x, pl, rtol)["beyond"] / (2.0 ** -8 * top)}
        if t is not None:
            res[label]["plain_tc"] = oracle_gap(torch, t, o, rtol)
            res[label]["kernel_vs_plain_tc_steps"] = oracle_gap(
                torch, x, t, rtol)["beyond"] / (2.0 ** -8 * top)
    res["out_tiled"] = {"kernel": oracle_gap(
        torch, fwd[0], tiled_forward_oracle(torch, G, *args, scale),
        2.0 ** -7)}
    return res



def _k6_gaps(seeds: int, shapes=None) -> None:
    """Each K6 bf16 output's distance to the fp64 oracle of its rounding
    points (``k6_oracle_gaps``) over seeds at every shape of
    ``chip_smoke.K6_BF16_SHAPES`` (or those named in ``shapes``; 12
    heads; the backward on the body the tree's route takes there: the
    Hopper dq and dkv at the SAM @576-@896 global grids and DINOv2's kv_len
    shape, the mma.sync ones at SAM @544's 34 x 34 grid and at 14 x 14
    windows), beside the plain versions' distance (fp32 products, and the backward's also on the tensor cores)
    and the kernel's gap to the plain version in the rule's units
    (``chip_smoke.py``'s phase 10); one JSON line a shape and seed, after a
    line with the card and the fp32 matmul setting of the plain versions."""
    import json

    import torch

    from ..ops import attention_grad as G

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    scale = 0.125
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32}),
          flush=True)
    for tag, (b, s, kh, kw, kv_len) in cs.K6_BF16_SHAPES.items():
        if shapes and tag not in shapes:
            continue
        for seed in range(seeds):
            g = torch.Generator(device="cuda").manual_seed(100 + seed)
            args, dout = cs.k6_inputs(torch, g, torch.bfloat16, b, s, kh, kw,
                                      kv_len)
            fwd = G.flash_attention_fwd(*args, scale=scale)
            rest = (dout, fwd[1], G.flash_attention_delta(fwd[0], dout))
            bwd = (*G.flash_attention_bwd_dq(*args, *rest, scale=scale),
                   *G.flash_attention_bwd_dkv(*args, *rest, scale=scale))
            gaps = k6_oracle_gaps(torch, G, args, dout, fwd, bwd, scale,
                                  tensor_cores=True)
            print(json.dumps({"shape": tag, "seed": seed,
                              "body": G.flash_attention_bwd_route(*args),
                              "gaps": gaps}), flush=True)
            del args, dout, fwd, rest, bwd
            torch.cuda.empty_cache()


def _k5_fwd_plain(torch, G, q, kv, bh, bw, kl, heads, scale, step=2):
    """The K5 forward's plain version, ``step`` heads a call (at SAM
    @2048's shape one call over 12 heads would hold several (S, S) fp32
    score tensors of 12.9 GB): out (B, S, H·D) and lse (B, H, S)."""
    c = q.shape[-1]
    d = c // heads
    outs, lses = [], []
    for h0 in range(0, heads, step):
        cols = slice(h0 * d, (h0 + step) * d)
        kv_h = torch.cat([kv[..., cols],
                          kv[..., c + h0 * d:c + (h0 + step) * d]], -1)
        bias = [None if x is None else x[:, h0:h0 + step].contiguous()
                for x in (bh, bw)]
        out, lse = G.global_attention_fwd_lse_plain(
            q[..., cols].contiguous(), kv_h.contiguous(), *bias, kl,
            num_heads=step, scale=scale)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, -1), torch.cat(lses, 1)


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
            ref = _k5_fwd_plain(torch, G, *args, heads, scale)
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

            rc = fn(*c_args)
            if rc:   # e.g. a deeper ring than this shape's shared memory
                print(f"  {name}: launch refused (error {rc})")
                continue
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
    `parity` paths' shapes, of K3's bf16 Hopper body at SAM @768's and of
    its window mode (``k3win``) at chip_smoke.py phase 15's: gap to the
    plain version (bf16: beyond one step, 2^-7·|ref|), ms beside SDPA's in
    the same dtype (the dense bias, or -inf at every masked key, as
    ``attn_mask``; window mode one batch entry a window), share of the fp32
    CUDA-core peak (67 TFLOP/s) or of the bf16 tensor-core peak (989
    TFLOP/s, H100 SXM) on the work the call is handed, and the bound on the
    bytes the function must move (q and the output whole, K and V at the
    valid keys, the bias terms that reach a valid key; 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    fns = _build(kernel, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5
    bf16 = kernel in ("k3", "k3win")
    dtype = torch.bfloat16 if bf16 else torch.float32
    peak, rtol = (989e12, 2 ** -7) if bf16 else (67e12, 0.0)

    def rand(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(dtype)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, n_valid, *window in CALLS[kernel][1]:
        # K3's window mode: its kv_grid and the tokens of a window
        grid, win = window or (None, 0)
        bh = bw = kl = None
        if kh:
            bh, bw = rand(b, heads, s, kh, s=0.3), rand(b, heads, s, kw, s=0.3)
            if kernel.startswith("k3") and not win:
                grid = (kh, kh)
        else:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        sk = kh * kw if kh and not win else s
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
                                          window_tokens=win or None,
                                          scale=scale)
            views = [q, k, v]

            def c_args(out):
                return (*map(ptr, (q, k, v, bh, bw, kl, out)), b, heads, s,
                        sk, d, kh, kw, *(grid or (0, 0)), win, scale)
        # SDPA's batch entries and keys: one a window in window mode
        n_seg, seg = (s // win, win) if win else (1, sk)
        bias = (bh, bw)
        if win:
            def split(t):
                return t.reshape(b, heads, n_seg, win, t.shape[-1]) \
                    .transpose(1, 2).reshape(b * n_seg, heads, win,
                                             t.shape[-1]).contiguous()

            views, bias = list(map(split, views)), tuple(map(split, bias))
        key = torch.arange(seg, device="cuda")
        valid = key < (n_valid or seg)
        if grid:
            valid &= (key // kw < grid[0]) & (key % kw < grid[1])
        mask = torch.zeros(b * n_seg, heads, s // n_seg, seg, device="cuda",
                           dtype=dtype)
        if kh:
            mask = (bias[0][..., :, None] + bias[1][..., None, :]).reshape(
                mask.shape)
        mask = mask.masked_fill(~valid, float("-inf"))
        flops = 4.0 * b * heads * s * seg * d
        terms = (min(grid[0], kh) + min(grid[1], kw) if grid else kh + kw)
        nbytes = dtype.itemsize * b * heads * (
            2 * s * d + 2 * n_seg * int(valid.sum()) * d + s * terms)
        print(f"{kernel} shape ({b}, {heads}, {s}, {d}), Kh {kh}, Kw {kw}, "
              f"kv_len {n_valid}, kv_grid {grid}, windows of {win or None}: "
              f"bytes bound {nbytes / 3.35e12 * 1e3:.4f} ms "
              f"({nbytes / 1e6:.1f} MB)")
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
        del q, ref, views, mask, bh, bw, bias, kl
        torch.cuda.empty_cache()


# K7's width, hidden width and calls per forward: the Hopper body's (SAM
# ViT-B/16, DINOv2 ViT-B/14) and the C 1536 cluster body's (DINOv2
# ViT-g/14)
_K7_WIDTHS = {"k7": (768, 3072, 12), "k7wide": (1536, 6144, 40)}


def _k7_variants(kernel: str, out_dir: Path) -> None:
    """K7's variants (bf16, the weights in the torch Linear layout): the
    Hopper body at C 768, hidden 3072 (SAM's and DINOv2's rows) or the
    cluster body at C 1536, hidden 6144 (ViT-g/14's rows at batch 4 and
    1): gap to the plain
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
        y = torch.empty_like(x)       # the cluster body's LayerNorm output
        for name, fn in fns.items():
            out = torch.empty_like(x)
            args = (*map(ptr, (x, ln_s, ln_b, w1, b1, w2, b2, ls, out, y)),
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
        del x, y, ref
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
import dataclasses, hashlib, sys, time
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
    g = torch.Generator(device="cuda").manual_seed(size)
    x = torch.rand(4, size, size, 3, generator=g, device="cuda")
    with torch.no_grad():
        out = m(x)
        m(x)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(5):
            m(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
    n = {k: v // 5 for k, v in A.LAUNCHES.items() if v}
    sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"forward parity @{size} B=4, mean of 5: {dt * 1e3:.3f} ms = "
          f"{4 / dt:.2f} img/s; launches per forward {n}; output sha256 "
          f"{sha}", flush=True)
    del m, x, out
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
# K3 fp32 at the @768 path's shape: 2304 query rows, the 48 x 48 grid
# padded to 48 x 64 keys
q = torch.randn(b, h, 2304, d, generator=g, device="cuda")
k, v = (torch.randn(b, h, 3072, d, generator=g, device="cuda")
        for _ in range(2))
bh, bw = (0.3 * torch.randn(b, h, 2304, n, generator=g, device="cuda")
          for n in (48, 64))
def k3():
    return A.flash_attention(q, k, v, bh, bw, kv_grid=(48, 48),
                             block_q=2304, block_k=3072)
sha = hashlib.sha256(k3().cpu().numpy().tobytes()).hexdigest()[:16]
ms = cs.cuda_ms(torch, k3, 10)
print(f"kernel flash_attention fp32 [sam768_global]: ms {ms:.4f} sha256 "
      f"{sha}")
del q, kv, k, v, bh, bw
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

# SAM @2048 under `fast` (its global layers on the K5 kernels at Kw 128):
# one B=1 fine-tuning step traced (wall, device, idle share, top device
# costs), the K5 kernels' ms at Kw 128, and the bits of the K5 forward's
# and backward's outputs at Kw 64 and without a bias and of K2 bf16's at
# Kw 64, Kw 128 and without a bias. It uses only what the trees before the
# Kw 128 bodies have (FineTuner's backbone_cfg, trace_runs).
_PAIR_FAST2048_CHILD = r'''
import dataclasses, hashlib, sys
sys.path.insert(0, ".")
import torch
from vit_deep_radiomics_tpu_torch.engine import finetune as ft
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build, profiling
from vit_deep_radiomics_tpu_torch.ops import attention as A
cuda_build.build_all(("fused_window_attention", "window_attention_bwd",
                      "global_attention_fwd_lse", "global_attention_bwd_dq",
                      "global_attention_bwd_dkv", "fused_global_attention"))
cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=2048)
tuner = ft.FineTuner(ft.FineTuneConfig(backbone_cfg=cfg))
state = tuner.init(seed=0)
g = torch.Generator(device="cuda").manual_seed(1)
images = torch.rand(1, 2048, 2048, 3, generator=g, device="cuda")
mask = torch.zeros(1, 128, 128, dtype=torch.bool, device="cuda")
mask[:, 48:80, 48:80] = True
labels = torch.eye(2, device="cuda")[:1]
torch.cuda.reset_peak_memory_stats()
r = profiling.trace_runs(lambda: tuner.step(state, images, mask, labels),
                         3, 8)
print(f"fine-tune fast @2048 B=1: wall {r['wall_ms']:.3f} ms, device "
      f"{r['device_ms']:.3f} ms, idle {r['idle_share']:.3f}, peak memory "
      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
for x in r["top"]:
    print(f"  {x['ms']:9.3f} ms {x['calls']:5.1f}x {x['name'][:70]}")
del tuner, state, images
torch.cuda.empty_cache()


def rand(*shape, s=1.0):
    return (torch.randn(*shape, generator=g, device="cuda") * s).to(
        torch.bfloat16)


def ms(fn, iters):
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


def k5_inputs(b, s, kh, kw, n_valid):
    q, kv, dout = rand(b, s, 768), rand(b, s, 1536), rand(b, s, 768)
    bh = bw = kl = None
    if kh:
        bh, bw = rand(b, 12, s, kh, s=0.3), rand(b, 12, s, kw, s=0.3)
    else:
        kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
    kw_ = dict(num_heads=12, scale=0.125)
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, kl, **kw_)
    return (q, kv, bh, bw, kl), (q, kv, bh, bw, kl, dout, lse,
                                 G.attention_delta(out, dout, 12)), kw_


def sha(*outs):
    h = hashlib.sha256()
    for o in outs:
        if o is not None:
            h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


for b, kh in ((1, 32), (1, 128)):
    fa, args, kw_ = k5_inputs(b, kh * 128, kh, 128, None)
    print(f"k5 Kw 128 [B={b}, Kh {kh}]: fwd ms "
          f"{ms(lambda: G.global_attention_fwd_lse(*fa, **kw_), 5):.4f}, dq "
          f"ms {ms(lambda: G.global_attention_bwd_dq(*args, **kw_), 5):.4f}"
          f", dkv ms "
          f"{ms(lambda: G.global_attention_bwd_dkv(*args, **kw_), 5):.4f}",
          flush=True)
    del fa, args
    torch.cuda.empty_cache()
for tag, shape in {"kw64": (2, 4096, 64, 64, None),
                   "no bias, kv_len": (2, 1536, 0, 0, 1370)}.items():
    fa, args, kw_ = k5_inputs(*shape)
    h = hashlib.sha256()
    for o in (*G.global_attention_bwd_dq(*args, **kw_),
              G.global_attention_bwd_dkv(*args, **kw_)):
        if o is not None:
            h.update(o.view(torch.int16).cpu().numpy().tobytes())
    print(f"k5 backward [{tag}]: sha256 {h.hexdigest()[:16]}")
    print(f"k5 forward [{tag}]: sha256 "
          f"{sha(*G.global_attention_fwd_lse(*fa, **kw_))}")
    del fa, args
# K2 bf16 (inference): its Kw 64, Kw 128 (both bias_w register sets) and
# no-bias instances
for tag, shape in {"kw64": (4, 4096, 64, 64, None),
                   "kw128": (1, 4096, 32, 128, None),
                   "no bias, kv_len": (4, 1536, 0, 0, 1370)}.items():
    fa, args, kw_ = k5_inputs(*shape)
    print(f"k5 K2 bf16 [{tag}]: sha256 "
          f"{sha(A.fused_global_attention(*fa, **kw_))}")
    del fa, args
'''

# SAM @768 under `fast` fine-tuning (its global layers' 48 x 48 grid on K6
# in bf16, its windowed layers on K1/K4): chip_smoke.py's phase 24 (five B=2
# steps with their launches held, then traced steps: device ms, idle
# share), then at each of chip_smoke.py's K6_BF16_SHAPES (its phase 10
# inputs) the three K6 kernels' ms in bf16, the whole bf16 SDPA backward's
# ms (chip_smoke._sdpa_ms: the dense bias or the padding mask as a
# trainable attn_mask), SDPA's forward, and two SHA-256s: of the
# forward's outputs (out, lse) and of the backward's (dq, both bias
# gradients, dk, dv); each may differ between the trees only where a
# tree's route gives the forward or the backward another body (its sums
# run in another order; the backward is fed the forward's lse and D)
_PAIR_FINETUNE768_CHILD = r'''
import hashlib, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.engine import finetune as ft
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_window_attention", "window_attention_bwd",
                      *cs.K6_NAMES))
cs.sam768_phase(torch, A, ft, vit)
torch.cuda.empty_cache()


def sha(*outs):
    h = hashlib.sha256()
    for o in outs:
        if o is not None:
            h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


g = torch.Generator(device="cuda").manual_seed(1)
for tag, shape in cs.K6_BF16_SHAPES.items():
    b, s, kh = shape[:3]
    args, dout = cs.k6_inputs(torch, g, torch.bfloat16, *shape)
    out, lse = G.flash_attention_fwd(*args, scale=0.125)
    rest = (dout, lse, G.flash_attention_delta(out, dout))
    grads = (*G.flash_attention_bwd_dq(*args, *rest, scale=0.125),
             *G.flash_attention_bwd_dkv(*args, *rest, scale=0.125))
    fwd, dq, dkv = (
        cs.cuda_ms(torch, lambda fn=fn, a=a: fn(*a, scale=0.125), 5)
        for fn, a in ((G.flash_attention_fwd, args),
                      (G.flash_attention_bwd_dq, (*args, *rest)),
                      (G.flash_attention_bwd_dkv, (*args, *rest))))
    q, k, v, bh, bw, kl = args
    if kh:
        mask = (bh[..., :, None] + bw[..., None, :]).reshape(
            b, 12, s, s).to(torch.bfloat16)
    else:
        key = torch.arange(s, device="cuda")
        mask = torch.zeros(b, 12, s, s, device="cuda",
                           dtype=torch.bfloat16).masked_fill(
            key >= shape[4], float("-inf"))
    sdpa = cs._sdpa_ms(torch, q, k, v, mask, 0.125, dout,
                       mask_grad=bool(kh))[0]
    sdpa_fwd = cs._sdpa_ms(torch, q, k, v, mask, 0.125)[0]
    print(f"k6 bf16 [{tag}, forward {G.flash_attention_route(*args)}]: fwd "
          f"ms {fwd:.4f} (sdpa forward ms {sdpa_fwd:.4f}), dq ms {dq:.4f}, "
          f"dkv ms {dkv:.4f}, dq + dkv ms {dq + dkv:.4f}, sdpa backward ms "
          f"{sdpa:.4f}; sha256 forward {sha(out, lse)} backward "
          f"{sha(*grads)}", flush=True)
    del args, dout, out, lse, rest, grads, mask, q, k, v, bh, bw, kl
    torch.cuda.empty_cache()
'''

# SAM ViT-B/16 `fast` fine-tuning at @SIZE@ px, B=2 (``--path finetune-576``,
# ``finetune-640``, ``finetune-896``, ``finetune-960``): 5 steps through
# chip_smoke.py's finetune_phase, their launches held to K1 and K4 8 and
# the K6 bf16 forward, dq and dkv 4 each under the bodies the tree's routes
# name at the global layers' grid, then traced steps (wall, device ms, idle
# share, top device costs); then, at the global grid of each size of
# @TIME_SIZES@ (the step's size last), the forward's and the backward's
# bodies, the three K6 kernels' ms in bf16 (B=2, 12 heads, inputs from
# chip_smoke.k6_inputs), the bf16 SDPA forward's and whole backward's, and
# SHA-256s of the forward's and the backward's outputs
_PAIR_FINETUNE_SIZE_CHILD = r'''
import dataclasses, hashlib, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.engine import finetune as ft
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_window_attention", "window_attention_bwd",
                      *cs.K6_NAMES))
size = @SIZE@
grid = size // 16
shape = (2, grid * grid, grid, grid, None)
g = torch.Generator(device="cuda").manual_seed(1)
args, dout = cs.k6_inputs(torch, g, torch.bfloat16, *shape)
body = G.flash_attention_bwd_route(*args)
fwd_body = G.flash_attention_route(*args)
del args, dout
suffix = "_hopper" if body == "hopper" else "_bf16"
fwd_suffix = "_hopper" if fwd_body == "hopper" else "_bf16"
per_step = {"fused_window_attention": 8, "window_attention_bwd": 8,
            "flash_attention_fwd" + fwd_suffix: 4,
            "flash_attention_bwd_dq" + suffix: 4,
            "flash_attention_bwd_dkv" + suffix: 4}
print(f"k6 bf16 [@{size}]: forward body {fwd_body}, backward body {body}",
      flush=True)
cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=size)
counts, summary = cs.finetune_phase(torch, A, ft, per_step=per_step,
                                    backbone_cfg=cfg, trace=True)
torch.cuda.empty_cache()


def sha(*outs):
    h = hashlib.sha256()
    for o in outs:
        if o is not None:
            h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


for at in @TIME_SIZES@:
    grid = at // 16
    shape = (2, grid * grid, grid, grid, None)
    b, s = shape[:2]
    g = torch.Generator(device="cuda").manual_seed(1)
    args, dout = cs.k6_inputs(torch, g, torch.bfloat16, *shape)
    body = G.flash_attention_bwd_route(*args)
    fwd_body = G.flash_attention_route(*args)
    out, lse = G.flash_attention_fwd(*args, scale=0.125)
    rest = (dout, lse, G.flash_attention_delta(out, dout))
    grads = (*G.flash_attention_bwd_dq(*args, *rest, scale=0.125),
             *G.flash_attention_bwd_dkv(*args, *rest, scale=0.125))
    fwd, dq, dkv = (
        cs.cuda_ms(torch, lambda fn=fn, a=a: fn(*a, scale=0.125), 10)
        for fn, a in ((G.flash_attention_fwd, args),
                      (G.flash_attention_bwd_dq, (*args, *rest)),
                      (G.flash_attention_bwd_dkv, (*args, *rest))))
    q, k, v, bh, bw, kl = args
    mask = (bh[..., :, None] + bw[..., None, :]).reshape(b, 12, s, s).to(
        torch.bfloat16)
    sdpa = cs._sdpa_ms(torch, q, k, v, mask, 0.125, dout,
                       mask_grad=True)[0]
    sdpa_fwd = cs._sdpa_ms(torch, q, k, v, mask, 0.125)[0]
    print(f"k6 bf16 [@{at} global {shape}, forward {fwd_body}, backward "
          f"{body}]: fwd ms {fwd:.4f} (sdpa forward ms {sdpa_fwd:.4f}), dq "
          f"ms {dq:.4f}, dkv ms {dkv:.4f}, dq + dkv ms {dq + dkv:.4f}, sdpa "
          f"backward ms {sdpa:.4f}; sha256 forward {sha(out, lse)} backward "
          f"{sha(*grads)}", flush=True)
    del args, dout, out, lse, rest, grads, q, k, v, bh, bw, kl, mask
    torch.cuda.empty_cache()
'''


def _finetune_child(size: int, time_sizes=None) -> str:
    """The ``finetune-<size>`` child: the step at ``size`` px, then the K6
    bf16 kernels at each of ``time_sizes`` (default: ``size`` alone)."""
    return (_PAIR_FINETUNE_SIZE_CHILD.replace("@SIZE@", str(size))
            .replace("@TIME_SIZES@", repr(tuple(time_sizes or (size,)))))

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

# K7 at C 1536: chip_smoke.py's phase 16 (ViT-g/14's rows among its
# shapes), then its phase 19 for the ViT-g/14 `full` @518 path with
# VDR_FUSED_MLP=1 alone (the B=4 forward: host ms, device ms, idle share,
# top device costs; the batch-1 checks; a one-patient extraction)
_PAIR_DINOV2_CHILD = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.core import precision
from vit_deep_radiomics_tpu_torch.data import synthetic as syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_global_attention", "fused_ln_mlp_residual"))
sku, peaks = cs.peaks_for(torch.cuda.get_device_name(0))
cs.k7_phase(torch, peaks)
cs.DINO_PATHS = {k: v for k, v in cs.DINO_PATHS.items()
                 if k.startswith("vitg14")}
cs.dinov2_extraction_phase(torch, A, vit, precision, tex, syn)
'''

# K1 in bf16 through its wrapper, one window a batch row, at SAM's 14 x 14
# windows and at 16 x 16 windows: route, ms (mean of 3 x 50 calls on CUDA
# events, after a warm-up) and a SHA-256 of the output
_PAIR_K1_CHILD = r'''
import hashlib, sys
sys.path.insert(0, ".")
import torch
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_window_attention",))
g = torch.Generator(device="cuda").manual_seed(3)


def rand(*shape, s=1.0):
    return (torch.randn(*shape, generator=g, device="cuda") * s).to(
        torch.bfloat16)


for side in (14, 16):
    b, s = 100, side * side
    q, kv = rand(b, s, 768), rand(b, s, 1536)
    bh, bw = rand(b, 12, s, side, s=0.3), rand(b, 12, s, side, s=0.3)
    opts = dict(num_heads=12, window_tokens=s, scale=0.125)
    route = A.fused_window_attention_route(q, kv, bh, bw, **opts)
    out = A.fused_window_attention(q, kv, bh, bw, **opts)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            A.fused_window_attention(q, kv, bh, bw, **opts)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 50)
    sha = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes())
    print(f"kernel K1 [{side} x {side} windows]: route {route}, ms "
          f"{sum(times) / 3:.4f} ({', '.join(f'{x:.4f}' for x in times)}), "
          f"sha256 {sha.hexdigest()[:16]}", flush=True)
'''

_CHILDREN = {"extraction": _PAIR_CHILD, "parity": _PAIR_PARITY_CHILD,
             "fast": _PAIR_FAST_CHILD, "fast-768": _PAIR_FAST768_CHILD,
             "fast-2048": _PAIR_FAST2048_CHILD,
             "finetune-768": _PAIR_FINETUNE768_CHILD,
             "finetune-544": _finetune_child(544, (592, 544)),
             "finetune-576": _finetune_child(576),
             "finetune-640": _finetune_child(640),
             "finetune-896": _finetune_child(896),
             "finetune-960": _finetune_child(960, (704, 832, 960)),
             "parity-forward": _PAIR_PARITY_FORWARD_CHILD,
             "frozen": _PAIR_FROZEN_CHILD, "dinov2": _PAIR_DINOV2_CHILD,
             "k1": _PAIR_K1_CHILD}


def _pair(parent: Path, change: Path, path: str = "extraction") -> None:
    child = _CHILDREN[path]
    keep = ("forward", "extraction", "fine-tune", "k6 ", "k5 ", "kernel ",
            "Traceback")
    if path in ("dinov2", "fast-2048"):
        # top device costs, one a line
        keep += ("  ",)
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


_SASS_CHILD = r'''
import sys
sys.path.insert(0, ".")
from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb
names = sys.argv[1:]
cb.build_all(names)
for n in names:
    print(cb._target(n))
'''


def _kernel_key(name: str) -> str:
    """A kernel's mangled name without what may differ between two trees
    that build the same code: the hash nvcc gives an unnamed namespace and
    the parameter list (a parameter struct that moved to another
    namespace)."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_ZN", name)
    return name.split("EEv", 1)[0]


def _sass_functions(so: Path) -> dict:
    """{kernel: its SASS text} of one built library (``cuobjdump -sass``):
    the lines between a kernel's ``Function :`` line and the row of dots
    that ends its listing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _kernel_key(m.group(1))
            funcs[name] = []
        elif line.strip().startswith(".."):
            name = None
        elif name is not None:
            funcs[name].append(line.strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def _sass(parent: Path, change: Path, names, match: str) -> None:
    """Each kernel whose name holds ``match`` in the sources ``names``,
    built in both trees: the same SASS, another, or only in one tree."""
    libs = {}
    for tag, tree in (("parent", parent), ("change", change)):
        res = subprocess.run([sys.executable, "-c", _SASS_CHILD, *names],
                             cwd=tree, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{tag} build failed:\n{res.stderr[-2000:]}")
        libs[tag] = res.stdout.split()
    for name, a, b in zip(names, libs["parent"], libs["change"]):
        fa, fb = (_sass_functions(Path(x)) for x in (a, b))
        same = sorted(k for k in fa if match in k and fb.get(k) == fa[k])
        other = sorted(k for k in fa if match in k and k in fb and
                       fb[k] != fa[k])
        only = sorted(k for k in set(fa) ^ set(fb) if match in k)
        print(f"sass {name}: {len(same)} kernels the same, {len(other)} "
              f"another, {len(only)} in one tree only")
        for k in other + only:
            print(f"  {'another' if k in other else 'one tree'}: {k}")
            if k in other:
                a_, b_ = fa[k].splitlines(), fb[k].splitlines()
                diff = [ln for ln in difflib.unified_diff(a_, b_, n=0,
                                                          lineterm="")
                        if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
                print(f"    {len(a_)} / {len(b_)} lines, {len(diff)} "
                      "differ; the first:")
                for ln in diff[:8]:
                    print(f"    {ln[:150]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("variants", help="kernel variants at the path shapes")
    v.add_argument("kernel", choices=sorted(SOURCES))
    v.add_argument("--out", type=Path,
                   default=Path(__file__).resolve().parents[1] / "_build"
                   / "probe_variants")
    gp = sub.add_parser("gaps", help="K6 bf16 outputs against the fp64 "
                        "oracle of their rounding points")
    gp.add_argument("--seeds", type=int, default=10)
    gp.add_argument("--shape", action="append", dest="shapes",
                    help="a K6_BF16_SHAPES name (repeatable; default all)")
    sa = sub.add_parser("sass", help="parent vs change: the kernels' "
                        "SASS, kernel by kernel")
    sa.add_argument("--source", action="append", dest="sources",
                    help="a csrc/*.cu name (repeatable)")
    sa.add_argument("--match", default="hopper_kernel",
                    help="compare the kernels whose names hold this")
    sa.add_argument("parent", type=Path)
    sa.add_argument("change", type=Path)
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
        elif args.kernel.endswith("f32") or args.kernel.startswith("k3"):
            _forward_variants(args.kernel, args.out)
        else:
            _variants(args.kernel, args.out)
    elif args.cmd == "gaps":
        _k6_gaps(args.seeds, args.shapes)
    elif args.cmd == "sass":
        _sass(args.parent.resolve(), args.change.resolve(),
              args.sources or ["flash_attention_fwd",
                               "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"], args.match)
    else:
        _pair(args.parent.resolve(), args.change.resolve(), args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
