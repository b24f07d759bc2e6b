#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit):

1. card: name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` of every kernel under ``vit_deep_radiomics_tpu_torch/
   csrc`` for ``sm_90a``, one process per source, in parallel; the ptxas
   report of K4 and the K5 backward (TMA + wgmma), the register-tiled K6
   backward kernels and the register-tiled fp32 forward's kernels in K1's,
   K2's, K3's and the K6 forward's sources, K3's Hopper kernel and the
   Hopper kernels of the K5 forward, K7 and K8, and K7's C 1536 loop
   instance (registers, spills), which must show no spill (the K5 forward,
   K7 and K8 also no ``C75xx`` wgmma serialisation line);
3. kernels: K1 (window) and K2 (global) fused attention at the shapes of
   the extraction path (SAM ViT-B/16 @1024, slice batch 4), fp32 and
   bf16, held against their plain PyTorch versions (both C entries are
   asked which body they take: in bf16 the Hopper kernels, TMA and wgmma;
   in fp32 the register-tiled CUDA-core forward); kernel,
   plain-version and one library call's (SDPA with the dense bias as
   ``attn_mask``) times, and the card's bound for the same work;
4. forward: full-width SAM ViT-B/16 @1024 at batch 4 under ``fast``, with
   the launch counts of K1 and K2 per forward; the same forward under
   ``parity`` at batch 4 (K2 in fp32: host ms, device ms and idle share
   from a trace, launches asserted) and on one image against the port's
   plain-attention forward;
5. extraction: ``DenseExtractor.extract_volume`` on 2 synthetic patients,
   CT and PET, 256x256 in-plane, 3 flips x 4 angles (the main path: the
   launch counts of the JSON line come from this run), the transformed
   masks on the card against the CPU's, and a small volume against the
   plain-attention extractor;
6. sweep: the HDF5/parquet store through ``extract_isotropic_dataset``
   when h5py, pandas and pyarrow import (it says which it did);
7. trainable kernels: K4 (window backward) and the K5 forward, dq and dkv
   kernels at the fine-tuning path's shapes (SAM ViT-B/16 @1024, batch 2:
   50 windows of 196 tokens, 2 x 4096 tokens; 12 heads of 64, bf16), each
   output held against its plain PyTorch version (the C entries of K4 and
   the three K5 kernels are asked which body they take: the Hopper ones,
   TMA and wgmma), and the K5 chain (the kernel forward's out and lse fed
   to the dq and dkv kernels) against the plain chain; kernel,
   plain-version and library (SDPA forward or backward with the dense bias
   as a trainable ``attn_mask``) times and the card's bound; then the same
   for the three K5 kernels on a key grid 128 keys wide (B=1, Kh 32, 12
   heads: their mma.sync loops, the routes asked);
8. fine-tuning: ``FineTuner`` on full-width, full-depth SAM ViT-B/16 @1024
   under ``fast``, batch 2, 5 steps on a fixed synthetic batch (the main
   path of K4 and K5: launch counts per step, ms per step, img/s, peak
   memory, the loss of every step, parameters moved);
9. gradient check: one ``fast`` step's gradients at batch 1 through the
   fused trainable kernels against the same weights through plain
   attention under torch autograd;
10. K6 kernels: the generic trainable attention's forward, dq and dkv
    kernels (fp32) at the ``parity`` path's shapes (SAM windowed: 50
    windows x 12 heads x 196 tokens, Kh = Kw = 14; SAM global: 2 x 12 x
    4096, Kh = Kw = 64; DINOv2: 2 x 12 x 1536 with kv_len 1370), each
    output held against its plain version (the backward kernels fed the
    forward kernel's lse); kernel, plain-version, library (fp32 SDPA) times
    and the bound;
11. kv_len kernels: K2 and the three K5 kernels in kv_len mode at DINOv2
    ViT-B/14 @518's padded shape (1536 tokens, 1370 valid, bf16), each at
    its path's batch: K2 at the inference forward's 4, K5 at fine-tuning's
    2 (the K5 kernels' routes asked and the K5 chain held, as in phase 7);
    then K2 at DINOv2 ViT-L/14's and ViT-g/14's widths (16 and 24 heads,
    B=4, 1536 rows, 1370 valid);
12. parity fine-tuning: ``FineTuner`` on full-width SAM ViT-B/16 @1024
    under ``parity``, batch 2, 5 steps (the main path of K6: 12 launches of
    each K6 kernel per step, no other kernel);
13. DINOv2 ViT-B/14 @518 fine-tuning, batch 2, 5 steps under ``fast`` (K5
    in kv_len mode) and 5 under ``parity`` (K6 in kv_len mode), and one
    ``fast`` inference forward at batch 4 (K2 in kv_len mode);
14. parity gradient check: one ``parity`` step's gradients at batch 1
    through K6 against plain attention, per leaf about 1e-4 of the leaf's
    max |grad|;
15. K3, the generic flash attention, at the shapes its paths give it: SAM
    ViT-B/16 @768's global layers (q (4, 12, 2304, 64), k/v (4, 12, 3072,
    64): the 48x48 key grid padded to 48x64, ``kv_grid`` (48, 48)) in bf16
    and fp32, and in bf16 the same with the queries padded to 3072 as JAX
    pads them, the ``kv_len`` mode at q (4, 12, 1370, 64), k/v 1536 rows
    with 1370 valid keys, and the ``window_tokens`` mode (the 100 windows
    of batch 4 @1024 padded to 16x16, 4 per row: q (25, 12, 1024, 64),
    ``kv_grid`` (14, 14)); each against its plain version, with plain,
    SDPA and bound times, and the body its C entry takes (the Hopper
    kernel in bf16 but in window mode, the register-tiled forward in
    fp32);
16. K7, the fused LayerNorm -> MLP -> residual, at the SAM forward's rows
    (16384 x 768, hidden 3072, bf16), DINOv2 ViT-B/14's (4 x 1370, with
    layerscale) and DINOv2 ViT-g/14's (4 x 1370 x 1536, hidden 6144, with
    layerscale), against its plain version, its C entry asked which body
    it takes (the Hopper body, TMA and wgmma, at C 768; the loops' 32-row
    instance at C 1536); the library time is the unfused PyTorch path
    (LayerNorm, two cuBLAS GEMMs, GELU, residual);
17. K8 (TMA and wgmma, persistent), the s8 x s8 -> s32 matmul, at the
    five backbone contractions at batch 4 (M = 16384 and the windowed
    layers' 19600 rows padded to 19712), exactly equal to its plain
    version; ``torch._int_mm`` as the
    library time, the times and bounds summed over an ``int8`` forward's
    60 launches, and the rate probes (K8 and ``torch._int_mm`` against
    the bf16 matmul at each shape, and the CLI guard's ratio);
18. paths: full-width SAM ViT-B/16 forwards at batch 4 under
    ``inference`` @1024, ``int8`` @1024 (K8), ``fast`` with
    ``VDR_FUSED_MLP=1`` @1024 (K7), ``fast`` @768 (K3) and ``parity`` @768
    (K3 in fp32: host and device ms), launch counts asserted, each held at
    batch 1 to an oracle on the same weights, then
    one ``DenseExtractor.extract_volume`` per new path (``int8``, fused
    MLP, 768 px) with its launch counts, ms and img/s;
19. DINOv2 extraction under ``fast``: ViT-L/14 ``full`` @518 (a B=4
    forward with host ms, device ms and idle share, K2's 24 launches
    asserted, held at batch 1 against plain attention, then one
    ``extract_volume`` of a synthetic patient, CT through HU→RGB and PET),
    ViT-L/14 ``patch_embed`` @896 (the same extraction: no kernel
    launched, a 64 x 64 x 1024 grid) and ViT-g/14 ``full`` @518 with
    ``VDR_FUSED_MLP=1`` (a B=4 forward with 40 K7 and 40 K2 launches, held
    at batch 1 against the unfused forward, one extraction).

Every phase runs at full width and depth. The line before the last is the
kernels' JSON record, and the last line is ``{"ok": true, "device":
{...}}``. Random weights from a seed; no network.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
# Dense peaks of the H100 variants (NVIDIA data sheets): device memory rate
# (B/s), bf16 tensor-core and fp32 CUDA-core FLOP/s.
PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "NVL": (3.9e12, 835e12, 60e12),
    "SXM": (3.35e12, 989e12, 67e12),
}
# Kernel vs plain version, elementwise: |out - ref| <= ATOL + RTOL·|ref|.
# Both round their output to the dtype, so in bf16 they may sit one step,
# at most 2^-7·|ref|, apart; ATOL bounds the fp32 gap before that rounding
# (the order of the sums, and where P is rounded to bf16 for the PV
# product), about 1.5 times the gap measured on an H100 SXM (PERF.md:
# bf16 K1 3.27e-3 on its first kernel, 1.98e-3 on the wgmma one, K2
# 5.98e-4 on its first kernel, 4.62e-4 on the wgmma one; fp32 K1 2.6e-6,
# K2 1.2e-6).
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
ATOL = {"fused_window_attention": {"float32": 2e-5, "bfloat16": 5e-3},
        "fused_global_attention": {"float32": 2e-5, "bfloat16": 1e-3}}
# The trainable kernels (bf16 only), the same elementwise rule on each
# output against the plain version in fp32 from the same bf16 inputs; the
# lse residual is fp32 on both sides and held absolutely. Limits are about
# 1.5 times the gap measured on an H100 SXM (PERF.md).
# Measured: K4 1.135e-2 (dbias_w; dq 7.6e-3, dkv 6.7e-3), K5 forward
# 5.6e-4 and lse 2.58e-3, dq 9.1e-4 (dbias_w), dkv 9.8e-4; the K5
# backward's Hopper bodies dq 9.08e-4 (dbias_w), dkv 9.83e-4; the K5
# forward's Hopper body 8.25e-4 and lse 2.58e-3.
TRAIN_ATOL = {"window_attention_bwd": 1.7e-2,
              "global_attention_fwd_lse": 9e-4, "lse": 4e-3,
              "global_attention_bwd_dq": 1.4e-3,
              "global_attention_bwd_dkv": 1.5e-3}
# Fine-tuning launches per step without remat (8 windowed, 4 global layers)
STEP_LAUNCHES = {"fused_window_attention": 8, "fused_global_attention": 0,
                 "window_attention_bwd": 8, "global_attention_fwd_lse": 4,
                 "global_attention_bwd_dq": 4, "global_attention_bwd_dkv": 4}
FT_STEPS = 5
K6_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
# Sources whose ptxas report must show no spill: K4 and the K5 backward
# (TMA + wgmma under setmaxnreg) and the register-tiled K6 backward
NO_SPILL = ("window_attention_bwd", "global_attention_bwd_dq",
            "global_attention_bwd_dkv", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
# Sources that carry the register-tiled fp32 forward (f32_tiled_forward.cuh):
# its kernels (with and without bias, *tiled_kernel*) must show no spill
TILED_SOURCES = ("fused_window_attention", "fused_global_attention",
                 "flash_attention", "flash_attention_fwd")
# Sources with Hopper kernels (*hopper_kernel*, this many) that must show
# no spill and no wgmma serialisation (ptxas's C75xx lines): the K5 forward
# (K2's body with the lse store, without and with the bias), K7 and K8
HOPPER_SOURCES = {"global_attention_fwd_lse": 2, "fused_ln_mlp_residual": 1,
                  "int8_matmul": 1}
# The body each kernel's C entry takes at its path's shapes: K1 and K2 by
# dtype at the extraction path's, the K5 forward at SAM's global layers
# (Kw 64) and DINOv2's kv_len layers
BODIES = {"fused_window_attention": {"bfloat16": "hopper", "float32": "tiled"},
          "fused_global_attention": {"bfloat16": "hopper", "float32": "tiled"},
          "global_attention_fwd_lse": {"sam_global": "hopper",
                                       "kv_len": "hopper"}}
K5_NAMES = ("global_attention_fwd_lse", "global_attention_bwd_dq",
            "global_attention_bwd_dkv")
# Per step of a 12-layer backbone: every layer runs K6 under `parity`;
# DINOv2's layers run K5 (kv_len mode) under `fast`
PARITY_STEP_LAUNCHES = dict.fromkeys(K6_NAMES, 12)
DINO_FAST_STEP_LAUNCHES = dict.fromkeys(K5_NAMES, 12)
# K6 (fp32) against its plain versions, both fp32: |out - ref| <= atol, the
# order of the sums alone. About 1.5 times the largest gap measured on an
# H100 SXM at the three path shapes (PERF.md).
# Measured: forward 1.55e-6 (out), 6.68e-6 (lse); dq 5.48e-6 (dbias_w, SAM
# windowed); dkv 1.79e-6.
K6_ATOL = {"flash_attention_fwd": 2.5e-6, "lse": 1e-5,
           "flash_attention_bwd_dq": 8.5e-6, "flash_attention_bwd_dkv": 3e-6}
# K6 at the `parity` path's shapes: (batch entries, tokens, Kh, Kw, kv_len)
K6_SHAPES = {"sam_window": (50, 196, 14, 14, None),
             "sam_global": (2, 4096, 64, 64, None),
             "dinov2": (2, 1536, 0, 0, 1370)}
# K2 and K5 in kv_len mode at DINOv2 ViT-B/14 @518's padded shape (bf16,
# the rule of phases 3 and 7); limits about 1.5 times the measured gap:
# K2 8.91e-4 (7.10e-4 on the wgmma kernel), K5 forward 8.91e-4 and lse
# 2.69e-3 (the Hopper body 9.08e-4, 2.72e-3), dq 1.59e-3, dkv 1.69e-3
# (the Hopper bodies 9.54e-4, 1.77e-3).
KV_ATOL = {"fused_global_attention": 1.4e-3,
           "global_attention_fwd_lse": 1.4e-3, "lse": 4e-3,
           "global_attention_bwd_dq": 2.4e-3,
           "global_attention_bwd_dkv": 2.5e-3}
# The K5 chain (the kernel forward's out and lse fed to the kernel dq and
# dkv) against the plain chain (the plain forward's fed to the plain
# backward), the rule of phase 7 on each gradient; limits about 1.5 times
# the gap measured on an H100 SXM (PERF.md): SAM dq 6.77e-4, dbias_h
# 8.07e-4, dbias_w 8.15e-4, dkv 9.23e-4; kv_len dq 8.90e-4, dkv 1.17e-3
CHAIN_ATOL = {"sam_global": {"dq": 1e-3, "dbias_h": 1.2e-3,
                             "dbias_w": 1.2e-3, "dkv": 1.4e-3},
              "kv_len": {"dq": 1.4e-3, "dkv": 1.8e-3},
              "kw128": {"dq": 1e-3, "dbias_h": 1.3e-3, "dbias_w": 1.2e-3,
                        "dkv": 1.4e-3}}
# The K5 kernels at a key grid 128 keys wide (SAM's global layers at 2048
# px, which JAX takes; no published config reaches it): B=1, Kh 32, 12
# heads of 64, bf16, on their mma.sync loops, each output against its plain
# version and the chain against the plain chain; limits about 1.5 times
# the gap measured on an H100 SXM: out 4.87e-4, lse 2.40e-3, dq 5.88e-4,
# dbias_h 2.87e-3, dbias_w 2.08e-3, dkv 9.40e-4; chain dq 4.98e-4, dbias_h
# 8.54e-4, dbias_w 5.30e-4, dkv 6.98e-4. dbias_h and dbias_w sit further
# from the plain version than at Kw 64 because the backward kernel is fed
# the kernel forward's lse, scored on Q^ = bf16(q D^-1/2 log2 e), where the
# plain version scores the fp32 q: fed Q^ instead, the plain version gives
# the kernel's bias gradients within one bf16 step (3.2e-8 beyond it;
# tests/test_torch_cuda_kernels.py); the chain,
# which scores alike on each side, stays within the Kw 64 limits
KW128 = (1, 32, 128)
KW128_ATOL = {"global_attention_fwd_lse": 9e-4, "lse": 4e-3,
              "global_attention_bwd_dq": 4.5e-3,
              "global_attention_bwd_dkv": 1.5e-3}
DINO_TOKENS, DINO_PADDED = 1370, 1536
DINO_FWD_BATCH = 4                  # the DINOv2 inference forward's batch
# K2 in kv_len mode at DINOv2 ViT-L/14's and ViT-g/14's widths (16 and 24
# heads of 64) at the inference forward's batch, phase 11
DINO_WIDE = {"dinov2_vitl14": 16, "dinov2_vitg14": 24}
# Dense int8 tensor-core peaks (TOP/s) of the same H100 variants
INT8_PEAKS = {"PCIe": 1513e12, "NVL": 1671e12, "SXM": 1979e12}
# K3 against its plain version, the rule of phase 3. Measured on an H100
# SXM: bf16 1.01e-3 (SAM @768), 9.24e-4 (kv_len), 3.66e-3 (window); fp32
# 1.25e-6. bf16: 1.5 times the window mode's gap; fp32: the limit of the
# CPU tests against JAX
K3_ATOL = {"float32": 2e-5, "bfloat16": 5.5e-3}
# K7 against its plain version: one bf16 step plus this, about 1.5 times
# the gap measured on an H100 SXM at SAM's 16384 rows (1.49e-2: the branch
# output and the residual sum round twice, a flip of the first moves the
# second; 100 rows read 6.35e-3)
K7_ATOL = 2.5e-2
# K7 at DINOv2 ViT-g/14's rows at batch 4 (4 x 1370, C 1536, hidden 6144,
# with layerscale): the loops' 32-row instance; the C 768 shapes take the
# Hopper body
K7_SHAPES = {"sam": (4, 4096, 768, 3072, False, "hopper"),
             "dinov2": (4, 1370, 768, 3072, True, "hopper"),
             "dinov2_vitg14": (4, 1370, 1536, 6144, True, "loops")}
# Phase 18's forwards: launches per forward of each path (every other
# counter 0), and each path's batch-1 oracle limit beyond one bf16 step.
# Measured on an H100 SXM: `inference` equals `fast` on the bf16-rounded
# weights bit for bit (0 allows no more than one step anywhere); 12 K7
# layers against the unfused forward 4.07e-2, the limit about 1.5 times
# that
PATH_LAUNCHES = {
    "inference": dict(fused_window_attention=8, fused_global_attention=4),
    "int8": dict(int8_matmul=60, fused_window_attention=8,
                 fused_global_attention=4),
    "fused_mlp": dict(fused_ln_mlp_residual=12, fused_window_attention=8,
                      fused_global_attention=4),
    "fast_768": dict(flash_attention=4, fused_window_attention=8),
}
PATH_ATOL = {"inference": 0.0, "fused_mlp": 6e-2}
# Phase 19, DINOv2 extraction: launches per forward of each path (every
# other counter 0) and the batch-1 limits beyond one bf16 step against the
# plain-attention (ViT-L) or unfused (ViT-g) forward on the same weights,
# about 1.5 times the gap measured on an H100 SXM (ViT-L/14's 24 layers
# 7.58e-2, ViT-g/14's 40 K7 layers 1.005e-1 with 16-row blocks, on outputs
# of max |x| 5.2 and 5.4; the 32-row blocks split the first product's sums
# otherwise and read 1.309e-1)
DINO_PATHS = {
    "vitl14_full": ("dinov2_vitl14", "full", {},
                    dict(fused_global_attention=24)),
    "vitl14_patch_embed": ("dinov2_vitl14", "patch_embed", {}, {}),
    "vitg14_full_fused_mlp": ("dinov2_vitg14", "full", {"VDR_FUSED_MLP": "1"},
                              dict(fused_global_attention=40,
                                   fused_ln_mlp_residual=40)),
}
DINO_ATOL = {"vitl14_full": 0.12, "vitg14_full_fused_mlp": 0.15}
INT8_MIN_COSINE = 0.995             # JAX tests/test_quant.py:116


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks_for(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
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


def kernel_phase(torch, A, peaks):
    """K1/K2 at the main path's shapes: error vs plain, times, bounds."""
    import torch.nn.functional as F

    bw_peak, bf16_peak, fp32_peak = peaks
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    specs = {
        "fused_window_attention": dict(
            b=100, s=196, seg=196, kh=14, kw=14,
            replaces="vit_deep_radiomics_tpu/ops/attention.py:542",
            source="vit_deep_radiomics_tpu_torch/csrc/"
                   "fused_window_attention.cu"),
        "fused_global_attention": dict(
            b=4, s=4096, seg=4096, kh=64, kw=64,
            replaces="vit_deep_radiomics_tpu/ops/attention.py:654",
            source="vit_deep_radiomics_tpu_torch/csrc/"
                   "fused_global_attention.cu"),
    }
    heads, d = 12, 64
    c = heads * d
    records = {}
    for name, sp in specs.items():
        rec = {"name": name, "route": "cuda", "source": sp["source"],
               "replaces": sp["replaces"]}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            b, s, seg, kh, kw = (sp[k] for k in ("b", "s", "seg", "kh",
                                                 "kw"))
            q = rand(b, s, c, dtype=dtype)
            kv = rand(b, s, 2 * c, dtype=dtype)
            bh = rand(b, heads, s, kh, dtype=dtype, scale=0.3)
            bwt = rand(b, heads, s, kw, dtype=dtype, scale=0.3)
            scale = d ** -0.5
            if name == "fused_window_attention":
                def kern():
                    return A.fused_window_attention(
                        q, kv, bh, bwt, num_heads=heads,
                        window_tokens=seg, scale=scale)

                def plain():
                    return A.fused_window_attention_plain(
                        q, kv, bh, bwt, num_heads=heads,
                        window_tokens=seg, scale=scale)
            else:
                def kern():
                    return A.fused_global_attention(
                        q, kv, bh, bwt, None, num_heads=heads, scale=scale)

                def plain():
                    return A.fused_global_attention_plain(
                        q, kv, bh, bwt, None, num_heads=heads, scale=scale)
            # the body the C entry takes: the Hopper kernels in bf16, the
            # register-tiled forward in fp32
            if name == "fused_window_attention":
                body = A.fused_window_attention_route(
                    q, kv, bh, bwt, num_heads=heads, window_tokens=seg,
                    scale=scale)
            else:
                body = A.fused_global_attention_route(
                    q, kv, bh, bwt, None, num_heads=heads, scale=scale)
            want_body = BODIES[name][dname]
            log(f"kernel {name} {dname}: body {body}")
            if body != want_body:
                raise AssertionError(
                    f"{name} {dname} takes the {body} body, not {want_body}")
            rec["body" if dtype == torch.bfloat16 else "fp32_body"] = body
            out = kern()
            torch.cuda.synchronize()
            ref = plain().float()
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            gap = (diff - RTOL[dname] * ref.abs()).max().item()
            ref_max = ref.abs().max().item()
            finite = bool(torch.isfinite(out.float()).all())
            del out, ref, diff
            # library yardstick: SDPA on head-major q/k/v with the dense
            # bias as attn_mask (built outside the timed call)
            nseg = s // seg
            qh, kh_, vh = (_heads_of(t, nseg, seg, heads)
                           for t in (q, kv[..., :c], kv[..., c:]))
            mask = _dense_mask(bh, bwt, nseg, seg, heads)
            iters = 20 if name == "fused_window_attention" else 10
            ms = cuda_ms(torch, kern, iters)
            plain_ms = cuda_ms(torch, plain, 3)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh_, vh, attn_mask=mask, scale=scale), 5)
            del qh, kh_, vh, mask
            # each input read once, the output (q's shape) written once
            nbytes = dtype.itemsize * (2 * q.numel() + kv.numel()
                                       + bh.numel() + bwt.numel())
            flops = 4.0 * b * nseg * heads * seg * seg * d
            t_bytes = nbytes / bw_peak * 1e3
            t_ops = flops / (bf16_peak if dtype == torch.bfloat16
                             else fp32_peak) * 1e3
            res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms, "bytes": nbytes, "flops": flops}
            atol = ATOL[name][dname]
            log(f"kernel {name} {dname}: max_abs_err {err:.3e} on max |ref| "
                f"{ref_max:.4f}; gap beyond {RTOL[dname]:.4g}·|ref| "
                f"{gap:.3e} (limit {atol:.0e}) ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{res['bound_ms']:.4f} ({res['bound_by']}; "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
            if not finite or not gap <= atol:
                raise AssertionError(
                    f"{name} {dname} disagrees with its plain version: "
                    f"max abs err {err}, gap {gap} > {atol} "
                    f"(finite={finite})")
            if dtype == torch.bfloat16:
                rec.update(dtype="bfloat16", **{
                    k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
            else:
                rec["fp32"] = res
            del q, kv, bh, bwt
            torch.cuda.empty_cache()
        records[name] = rec
    return records


def parity_forward_b4(torch, A, model, images, label, expect):
    """A full-width `parity` forward at B=4: host ms of one forward after a
    warm-up, its launch counts held to ``expect`` (every other counter 0),
    then the device ms and idle share over two traced forwards
    (``utils/profiling.py::trace_runs``). Returns the record."""
    from vit_deep_radiomics_tpu_torch.utils import profiling

    out, dt, n = _timed_forward(torch, A, model, images)
    b, grid = images.shape[0], images.shape[1] // 16
    if n != dict(dict.fromkeys(A.LAUNCHES, 0), **expect):
        raise AssertionError(f"{label}: launches per forward {n}")
    if tuple(out.shape) != (b, grid, grid, 256) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label} forward output is not finite or of "
                             "the expected shape")
    del out
    with torch.no_grad():
        res = profiling.trace_runs(lambda: model(images), 2, 6)
    rec = {"host_ms": dt * 1e3, "img_s": b / dt,
           "device_ms": res["device_ms"], "traced_wall_ms": res["wall_ms"],
           "idle_share": res["idle_share"], "launches": n}
    log(f"forward {label} B={b}: host {dt * 1e3:.3f} ms ({b / dt:.2f} "
        f"img/s); device {res['device_ms']:.3f} ms a forward (wall "
        f"{res['wall_ms']:.3f} ms, idle share {res['idle_share']:.3f}); "
        f"launches {n}")
    for row in res["top"]:
        log(f"  {row['ms']:9.3f} ms  {row['calls']:5.1f}x  {row['name']}")
    return rec


def forward_phase(torch, A, vit, precision):
    """Full-width SAM ViT-B/16 @1024 forwards: `fast` at B=4, `parity` at
    B=4 (K2 in fp32: host and device ms) and `parity` at B=1 against plain
    attention. Returns the weights and the `parity` B=4 record."""
    cfg = vit.SAM_VIT_B
    fast = vit.ViTDense(cfg, policy=precision.FAST).init_random(SEED)
    fast = fast.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.rand(4, 1024, 1024, 3, generator=gen, device="cuda")
    with torch.no_grad():
        fast(images)                                  # warm-up
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        out = fast(images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = dict(A.LAUNCHES)
    log(f"forward fast B=4: {dt * 1e3:.2f} ms ({4 / dt:.2f} img/s), "
        f"launches {counts}, out {tuple(out.shape)} {out.dtype}")
    if counts != dict(dict.fromkeys(A.LAUNCHES, 0),
                      fused_window_attention=8, fused_global_attention=4):
        raise AssertionError(f"launches per forward: {counts}")
    if tuple(out.shape) != (4, 64, 64, 256) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("fast forward output is not finite or of "
                             "the expected shape")
    state = fast.state_dict()
    del fast, out
    results = {}
    for use_flash in (True, False):
        m = vit.ViTDense(cfg, policy=precision.PARITY, use_flash=use_flash)
        m.load_state_dict(state)
        m = m.cuda().eval()
        if use_flash:
            parity = parity_forward_b4(
                torch, A, m, images, "parity @1024",
                dict(fused_window_attention=8, fused_global_attention=4))
        with torch.no_grad():
            results[use_flash] = m(images[:1]).float()
        del m
        torch.cuda.empty_cache()
    err = (results[True] - results[False]).abs().max().item()
    scale = results[False].abs().max().item()
    log(f"forward parity B=1, fused kernels vs plain attention: max abs "
        f"err {err:.3e} on outputs of max |x| {scale:.3f}")
    # fp32 through 12 layers: both paths differ only in the attention sum
    # order (measured ~1e-6 per kernel call)
    if not err <= 1e-4 * max(1.0, scale):
        raise AssertionError(f"parity forward disagrees: {err}")
    return state, parity


def extraction_phase(torch, A, tex, syn, state):
    """The main path: DenseExtractor.extract_volume on 2 patients."""
    cohort = syn.synthetic_cohort(n_patients=2, seed=SEED, height=256,
                                  width=256)
    ex = tex.DenseExtractor(tex.ExtractionConfig(precision="fast"),
                            state_dict=state)
    warm = syn.synthetic_volume(np.random.default_rng(9), 256, 256, 2,
                                modality="pet")
    ex.extract_volume(warm[0], warm[1], "pet")        # warm-up
    forwards = [0]
    ex.model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    ex.stats = tex.StageTimes()
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    n_images = 0
    outputs = []
    for pid, entry in cohort.items():
        for modality in ("ct", "pet"):
            vol, mask, _ = entry[modality]
            feats, masks, meta = ex.extract_volume(vol, mask, modality)
            n = len(ex.config.flips) * len(ex.config.angles) * vol.shape[2]
            n_images += n
            outputs.append((feats, masks, meta, n))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(A.LAUNCHES)
    forwards = forwards[0]
    log(f"extraction: 2 patients x (CT, PET) at 256x256, "
        f"{len(ex.config.flips)}x{len(ex.config.angles)} augmentations: "
        f"{n_images} images in {dt:.3f} s = {n_images / dt:.2f} img/s; "
        f"{forwards} forwards, launches {counts}")
    # host-clock stages: dispatch queues the device work, collect waits for
    # it and copies the crops back
    log("extraction stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(ex.stats.items())))
    expect = dict(dict.fromkeys(A.LAUNCHES, 0),
                  fused_window_attention=8 * forwards,
                  fused_global_attention=4 * forwards)
    if counts != expect:
        raise AssertionError(f"main-path launches {counts} != {expect}")
    for feats, masks, meta, n in outputs:
        if not (len(feats) == len(masks) == len(meta[0]) == n):
            raise AssertionError("extraction output lengths")
        for f, m in zip(feats, masks):
            if f.ndim != 3 or f.shape[2] != 256 or \
                    not np.isfinite(f).all() or m.ndim != 2:
                raise AssertionError(f"bad feature crop {f.shape}")
    return counts


def mask_phase(torch, syn):
    """Transformed masks on the card equal those on the CPU (which the CPU
    tests hold equal to the JAX package's) for every augmentation."""
    from vit_deep_radiomics_tpu_torch.engine.extract import ANGLES, FLIPS
    from vit_deep_radiomics_tpu_torch.ops.sampling import transform_mask

    cohort = syn.synthetic_cohort(n_patients=2, seed=SEED, height=256,
                                  width=256)
    n_diff = n_masks = 0
    for entry in cohort.values():
        for modality in ("ct", "pet"):
            mask = torch.as_tensor(entry[modality][1]).float()
            gpu_mask = mask.cuda()
            for flip in FLIPS:
                for angle in ANGLES:
                    args = (angle, flip == "horizontal", flip == "vertical",
                            tuple(mask.shape[:2]))
                    cpu = transform_mask(mask, *args)
                    gpu = transform_mask(gpu_mask, *args).cpu()
                    n_diff += int((cpu != gpu).sum())
                    n_masks += 1
    log(f"masks: {n_masks} transformed masks, card vs CPU: {n_diff} "
        f"pixels differ")
    if n_diff:
        raise AssertionError("transformed masks differ between card and CPU")


def extraction_reference_phase(torch, tex, syn, state):
    """A small volume: fused-kernel extractor vs the plain-attention
    extractor, both ``parity``, same weights."""
    vol, mask, _ = syn.synthetic_volume(np.random.default_rng(5), 256, 256,
                                        2, modality="ct")
    run = dict(precision="parity", flips=(None,), angles=(0, 90))
    outs = []
    for use_flash in (True, False):
        ex = tex.DenseExtractor(tex.ExtractionConfig(use_flash=use_flash,
                                                     **run),
                                state_dict=state)
        outs.append(ex.extract_volume(vol, mask, "ct"))
        del ex
        torch.cuda.empty_cache()
    (f1, m1, meta1), (f2, m2, meta2) = outs
    err = max(float(np.abs(a - b).max()) for a, b in zip(f1, f2))
    scale = max(float(np.abs(b).max()) for b in f2)
    same = meta1 == meta2 and all(np.array_equal(a, b)
                                  for a, b in zip(m1, m2))
    log(f"extraction parity, fused vs plain attention: max abs err "
        f"{err:.3e} (max |x| {scale:.3f}), masks/meta equal: {same}")
    if not same or not err <= 1e-4 * max(1.0, scale):
        raise AssertionError("extraction disagrees with the plain path")


def sweep_phase(tex, syn, state):
    try:
        import h5py  # noqa: F401
        import pandas  # noqa: F401
        import pyarrow  # noqa: F401
    except ImportError as exc:
        log(f"sweep: skipped, the HDF5/parquet store needs h5py, pandas "
            f"and pyarrow ({exc})")
        return
    from vit_deep_radiomics_tpu_torch.data import feature_store

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cohort = syn.synthetic_cohort(n_patients=2, seed=SEED, height=64,
                                      width=64, ct_slices=2, pet_slices=2)
        syn.write_isotropic_hdf5(cohort, tmp / "iso.hdf5", tmp / "iso.csv")
        ex = tex.DenseExtractor(tex.ExtractionConfig(
            flips=(None,), angles=(0, 90)), state_dict=state)
        kw = dict(modalities=("pet", "ct"), datasets=("stanford",))
        written = tex.extract_isotropic_dataset(
            tmp / "iso.hdf5", tmp / "iso.csv", tmp / "features", ex,
            progress=lambda *_: None, **kw)
        again = tex.extract_isotropic_dataset(
            tmp / "iso.hdf5", tmp / "iso.csv", tmp / "features", ex,
            progress=lambda *_: None, **kw)
        pids = feature_store.patient_ids_in_store(
            tmp / "features" / "features_masks_ct.hdf5")
        log(f"sweep: ran, wrote {len(written)} parquets, resume wrote "
            f"{len(again)}, CT store holds {len(pids)} patients")
        if len(written) != 4 or again or len(pids) != 2:
            raise AssertionError("sweep store contract")


def _sdpa_ms(torch, qh, kh, vh, mask, scale, dout=None, mask_grad=True):
    """Library yardstick: one SDPA call on the memory-efficient backend
    (forward, or with ``dout`` its backward through ``torch.autograd.grad``
    on a retained graph, the dense bias a trainable ``attn_mask`` unless
    ``mask_grad`` is False, as for a padding mask). Returns (ms, backend);
    a refusal of the backend fails the run."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    grad = dout is not None
    leaves = [t.detach().requires_grad_(grad) for t in (qh, kh, vh)]
    leaves.append(mask.detach().requires_grad_(grad and mask_grad))
    wrt = [t for t in leaves if t.requires_grad]

    def call():
        return F.scaled_dot_product_attention(
            *leaves[:3], attn_mask=leaves[3], scale=scale)

    backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel([backend]):
        if dout is None:
            return cuda_ms(torch, call, 5), backend.name
        out = call()
        return cuda_ms(torch, lambda: torch.autograd.grad(
            out, wrt, dout, retain_graph=True), 5), backend.name


def _heads_of(x, nseg, seg, heads):
    b = x.shape[0]
    return x.reshape(b * nseg, seg, heads, -1).transpose(1, 2).contiguous()


def _dense_mask(bh, bw, nseg, seg, heads):
    b = bh.shape[0]
    parts = [t.reshape(b, heads, nseg, seg, -1).transpose(1, 2)
             .reshape(b * nseg, heads, seg, -1) for t in (bh, bw)]
    return (parts[0][..., :, None] + parts[1][..., None, :]) \
        .reshape(b * nseg, heads, seg, seg).contiguous()


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _check_outputs(torch, name, outs, refs, labels, rtol, atol):
    """Each output against its plain version, elementwise
    |got - ref| <= atol + rtol·|ref|; returns the largest |got - ref|."""
    atols = atol if isinstance(atol, (list, tuple)) else [atol] * len(outs)
    worst = 0.0
    for got, ref, label, lim in zip(outs, refs, labels, atols):
        got, ref = got.float(), ref.float()
        diff = (got - ref).abs()
        err = diff.max().item()
        gap = (diff - rtol * ref.abs()).max().item()
        finite = bool(torch.isfinite(got).all())
        log(f"kernel {name} {label}: max_abs_err {err:.3e} on max |ref| "
            f"{ref.abs().max().item():.4f}; gap beyond {rtol:.4g}·|ref| "
            f"{gap:.3e} (limit {lim:.1e})")
        if not finite or not gap <= lim:
            raise AssertionError(f"{name} {label} disagrees with its "
                                 f"plain version: gap {gap} > {lim}")
        worst = max(worst, err)
    return worst


def _record(name, src, replaces, dtype, err, ms, plain_ms, lib, nb, flops,
            peaks, op_peak=None, library=None):
    """A kernel's JSON row; the bound is the larger of the bytes over the
    memory rate and the operations over the peak of the dtype's units (bf16
    tensor cores, fp32 CUDA cores, or ``op_peak``). ``lib`` is (ms, SDPA
    backend) unless ``library`` names another yardstick."""
    bw_peak, bf16_peak, fp32_peak = peaks
    if op_peak is None:
        op_peak = bf16_peak if dtype == "bfloat16" else fp32_peak
    t_bytes = nb / bw_peak * 1e3
    t_ops = flops / op_peak * 1e3
    library = library or f"sdpa {lib[1]}"
    rec = {"name": name, "route": "cuda",
           "source": f"vit_deep_radiomics_tpu_torch/csrc/{src}",
           "replaces": replaces, "dtype": dtype,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib[0], "library": library}
    log(f"kernel {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{lib[0]:.4f} ({library}) bound_ms {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}; {nb / 1e6:.1f} MB, {flops / 1e9:.1f} "
        f"GFLOP)")
    return rec


def _k5_bwd_routes(G, args, heads, tag):
    """Ask both K5 backward C entries which body they run for these
    operands; the path's shapes must take the Hopper one."""
    for kernel in ("dq", "dkv"):
        route = G.global_attention_bwd_route(*args[:5], num_heads=heads,
                                             kernel=kernel)
        log(f"kernel global_attention_bwd_{kernel} {tag}: route {route}")
        if route != "hopper":
            raise AssertionError(f"K5 {kernel} {tag} takes the {route} body, "
                                 "not the Hopper one")


def _k5_fwd_route(G, q, kv, bh, bw, kl, heads, shape, tag):
    """Ask the K5 forward's C entry which body it runs; the path's shapes
    must take ``BODIES``'s."""
    route = G.global_attention_fwd_route(q, kv, bh, bw, kl, num_heads=heads)
    want = BODIES["global_attention_fwd_lse"][shape]
    log(f"kernel global_attention_fwd_lse {tag}: route {route}")
    if route != want:
        raise AssertionError(f"K5 forward {tag} takes the {route} body, "
                             f"not the {want} one")


def _k5_chain(torch, G, fwd_args, dout, got, heads, kw, shape, tag):
    """The kernel chain's gradients ``got`` (dq, dbias_h, dbias_w, dkv: the
    K5 forward's out and lse fed to the dq and dkv kernels) against the
    plain chain's (the plain forward's fed to the plain backward), each
    elementwise under ``CHAIN_ATOL[shape]``; a forward that scored unlike
    the backward would show here. Returns the largest |got - want|."""
    out, lse = G.global_attention_fwd_lse_plain(*fwd_args, **kw)
    args = (*fwd_args, dout, lse, G.attention_delta(out, dout, heads))
    del out
    want = (*G.global_attention_bwd_dq_plain(*args, **kw),
            G.global_attention_bwd_dkv_plain(*args, **kw))
    labels = ("dq", "dbias_h", "dbias_w", "dkv")
    keep = [i for i, w in enumerate(want) if w is not None]
    return _check_outputs(
        torch, f"K5 chain {tag}", [got[i] for i in keep],
        [want[i] for i in keep], [labels[i] for i in keep], 2.0 ** -7,
        [CHAIN_ATOL[shape][labels[i]] for i in keep])


def train_kernel_phase(torch, A, G, peaks):
    """K4 and the three K5 kernels at the fine-tuning path's shapes (B=2):
    every output against the plain version, times, bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    heads, d = 12, 64
    c, scale, dt = heads * d, d ** -0.5, torch.bfloat16
    nbytes = _nbytes

    def rand(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * s).to(dt)

    def check(name, outs, refs, labels, rtol=2.0 ** -7, atol=None):
        return _check_outputs(torch, name, outs, refs, labels, rtol,
                              TRAIN_ATOL[name] if atol is None else atol)

    def record(name, src, replaces, err, ms, plain_ms, lib, nb, flops):
        return _record(name, src, replaces, "bfloat16", err, ms, plain_ms,
                       lib, nb, flops, peaks)

    records = {}
    # ---- K4: 50 windows of 14x14 tokens ----
    nwin, seg = 50, 196
    q, kv = rand(nwin, seg, c), rand(nwin, seg, 2 * c)
    bh, bw = rand(nwin, heads, seg, 14, s=0.3), rand(nwin, heads, seg, 14,
                                                     s=0.3)
    kw = dict(num_heads=heads, window_tokens=seg, scale=scale)
    out = A.fused_window_attention(q, kv, bh, bw, **kw)
    dout = rand(nwin, seg, c)
    args = (q, kv, bh, bw, out, dout)
    body = G.window_attention_bwd_route(q, kv, bh, bw, **kw)
    log(f"kernel window_attention_bwd: body {body}")
    if body != "hopper":
        raise AssertionError(f"K4 takes the {body} body, not the Hopper one")
    got = G.window_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    err = check("window_attention_bwd", got,
                G.window_attention_bwd_plain(*args, **kw),
                ("dq", "dkv", "dbias_h", "dbias_w"))
    ms = cuda_ms(torch, lambda: G.window_attention_bwd(*args, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: G.window_attention_bwd_plain(
        *args, **kw), 3)
    lib = _sdpa_ms(torch, _heads_of(q, 1, seg, heads),
                   _heads_of(kv[..., :c], 1, seg, heads),
                   _heads_of(kv[..., c:], 1, seg, heads),
                   _dense_mask(bh, bw, 1, seg, heads), scale,
                   _heads_of(dout, 1, seg, heads))
    records["window_attention_bwd"] = record(
        "window_attention_bwd", "window_attention_bwd.cu",
        "vit_deep_radiomics_tpu/ops/attention_grad.py:671", err, ms,
        plain_ms, lib, nbytes(*args, *got),
        10.0 * nwin * heads * seg * seg * d)
    records["window_attention_bwd"]["body"] = body
    del q, kv, bh, bw, out, dout, args, got
    torch.cuda.empty_cache()

    # ---- K5: 2 images x 4096 tokens ----
    b, s = 2, 4096
    q, kv = rand(b, s, c), rand(b, s, 2 * c)
    bh, bw = rand(b, heads, s, 64, s=0.3), rand(b, heads, s, 64, s=0.3)
    kw = dict(num_heads=heads, scale=scale)
    tag = "[SAM global, B=2]"
    _k5_fwd_route(G, q, kv, bh, bw, None, heads, "sam_global", tag)
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, None, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = G.global_attention_fwd_lse_plain(q, kv, bh, bw, None,
                                                        **kw)
    err = check("global_attention_fwd_lse", [out], [ref_out], ["out"])
    err = max(err, check("global_attention_fwd_lse", [lse], [ref_lse],
                         ["lse"], rtol=0.0, atol=TRAIN_ATOL["lse"]))
    del ref_out, ref_lse
    fwd_ms = cuda_ms(torch, lambda: G.global_attention_fwd_lse(
        q, kv, bh, bw, None, **kw), 10)
    fwd_plain = cuda_ms(torch, lambda: G.global_attention_fwd_lse_plain(
        q, kv, bh, bw, None, **kw), 3)
    qh, kh_, vh = (_heads_of(t, 1, s, heads)
                   for t in (q, kv[..., :c], kv[..., c:]))
    mask = _dense_mask(bh, bw, 1, s, heads)
    fwd_lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale)
    fl = 4.0 * b * heads * s * s * d
    records["global_attention_fwd_lse"] = record(
        "global_attention_fwd_lse", "global_attention_fwd_lse.cu",
        "vit_deep_radiomics_tpu/ops/attention_grad.py:1068", err, fwd_ms,
        fwd_plain, fwd_lib, nbytes(q, kv, bh, bw, out, lse), fl)

    dout = rand(b, s, c)
    delta = G.attention_delta(out, dout, heads)
    args = (q, kv, bh, bw, None, dout, lse, delta)
    _k5_bwd_routes(G, args, heads, tag)
    got = G.global_attention_bwd_dq(*args, **kw)
    torch.cuda.synchronize()
    err = check("global_attention_bwd_dq", got,
                G.global_attention_bwd_dq_plain(*args, **kw),
                ("dq", "dbias_h", "dbias_w"))
    dq_ms = cuda_ms(torch, lambda: G.global_attention_bwd_dq(*args, **kw), 10)
    dq_plain = cuda_ms(torch, lambda: G.global_attention_bwd_dq_plain(
        *args, **kw), 3)
    bwd_lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale,
                       _heads_of(dout, 1, s, heads))
    del qh, kh_, vh, mask
    torch.cuda.empty_cache()
    records["global_attention_bwd_dq"] = record(
        "global_attention_bwd_dq", "global_attention_bwd_dq.cu",
        "vit_deep_radiomics_tpu/ops/attention_grad.py:1168", err, dq_ms,
        dq_plain, bwd_lib, nbytes(*args[:4], *args[5:], *got), 1.5 * fl)
    dkv = G.global_attention_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    err = check("global_attention_bwd_dkv", [dkv],
                [G.global_attention_bwd_dkv_plain(*args, **kw)], ["dkv"])
    dkv_ms = cuda_ms(torch, lambda: G.global_attention_bwd_dkv(*args, **kw),
                     10)
    dkv_plain = cuda_ms(torch, lambda: G.global_attention_bwd_dkv_plain(
        *args, **kw), 3)
    records["global_attention_bwd_dkv"] = record(
        "global_attention_bwd_dkv", "global_attention_bwd_dkv.cu",
        "vit_deep_radiomics_tpu/ops/attention_grad.py:1255", err, dkv_ms,
        dkv_plain, bwd_lib, nbytes(*args[:4], *args[5:], dkv), 2.0 * fl)
    log("library yardstick of both K5 backward kernels: the whole SDPA "
        "backward (dq, dk, dv and the mask gradient in one call)")
    _k5_chain(torch, G, (q, kv, bh, bw, None), dout, (*got, dkv), heads, kw,
              "sam_global", tag)
    del q, kv, bh, bw, out, lse, dout, delta, args, got, dkv
    torch.cuda.empty_cache()
    k5_kw128(torch, G, peaks, records, rand)
    return records


def k5_kw128(torch, G, peaks, records, rand):
    """Phase 7, Kw 128: the three K5 kernels on a key grid 128 keys wide
    (``KW128``), each C entry asked for its body (the mma.sync loops), each
    output against its plain version, the kernel chain against the plain
    chain; times, SDPA and bounds go under each K5 record's
    ``by_shape["kw128"]``."""
    b, kh, kwidth = KW128
    heads, d = 12, 64
    c, scale, s = heads * d, d ** -0.5, kh * kwidth
    q, kv, dout = rand(b, s, c), rand(b, s, 2 * c), rand(b, s, c)
    bh = rand(b, heads, s, kh, s=0.3)
    bw = rand(b, heads, s, kwidth, s=0.3)
    kw = dict(num_heads=heads, scale=scale)
    tag = f"[Kw 128, B={b}, Kh {kh}]"
    routes = {"fwd": G.global_attention_fwd_route(q, kv, bh, bw,
                                                  num_heads=heads)}
    for kernel in ("dq", "dkv"):
        routes[kernel] = G.global_attention_bwd_route(
            q, kv, bh, bw, num_heads=heads, kernel=kernel)
    log(f"kernel K5 {tag}: routes {routes}")
    if set(routes.values()) != {"loops"}:
        raise AssertionError(f"K5 {tag} routes {routes}, not the loops")
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, None, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = G.global_attention_fwd_lse_plain(q, kv, bh, bw, None,
                                                        **kw)
    name = "global_attention_fwd_lse"
    errs = {name: max(
        _check_outputs(torch, f"{name} {tag}", [out], [ref_out], ["out"],
                       2.0 ** -7, KW128_ATOL[name]),
        _check_outputs(torch, f"{name} {tag}", [lse], [ref_lse], ["lse"],
                       0.0, KW128_ATOL["lse"]))}
    del ref_out, ref_lse
    args = (q, kv, bh, bw, None, dout, lse, G.attention_delta(out, dout,
                                                              heads))
    got = G.global_attention_bwd_dq(*args, **kw)
    dkv = G.global_attention_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    name = "global_attention_bwd_dq"
    errs[name] = _check_outputs(
        torch, f"{name} {tag}", got,
        G.global_attention_bwd_dq_plain(*args, **kw),
        ("dq", "dbias_h", "dbias_w"), 2.0 ** -7, KW128_ATOL[name])
    name = "global_attention_bwd_dkv"
    errs[name] = _check_outputs(
        torch, f"{name} {tag}", [dkv],
        [G.global_attention_bwd_dkv_plain(*args, **kw)], ["dkv"], 2.0 ** -7,
        KW128_ATOL[name])
    _k5_chain(torch, G, (q, kv, bh, bw, None), dout, (*got, dkv), heads, kw,
              "kw128", tag)
    qh, kh_, vh, doh = (_heads_of(t, 1, s, heads)
                        for t in (q, kv[..., :c], kv[..., c:], dout))
    mask = _dense_mask(bh, bw, 1, s, heads)
    fwd_lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale)
    bwd_lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale, doh)
    del qh, kh_, vh, doh, mask
    fl = 4.0 * b * heads * s * s * d
    rows = {
        "global_attention_fwd_lse": (
            lambda: G.global_attention_fwd_lse(q, kv, bh, bw, None, **kw),
            lambda: G.global_attention_fwd_lse_plain(q, kv, bh, bw, None,
                                                     **kw),
            fwd_lib, _nbytes(q, kv, bh, bw, out, lse), fl),
        "global_attention_bwd_dq": (
            lambda: G.global_attention_bwd_dq(*args, **kw),
            lambda: G.global_attention_bwd_dq_plain(*args, **kw), bwd_lib,
            _nbytes(*args[:4], *args[5:], *got), 1.5 * fl),
        "global_attention_bwd_dkv": (
            lambda: G.global_attention_bwd_dkv(*args, **kw),
            lambda: G.global_attention_bwd_dkv_plain(*args, **kw), bwd_lib,
            _nbytes(*args[:4], *args[5:], dkv), 2.0 * fl)}
    for name, (fn, plain, lib, nb, flops) in rows.items():
        rec = _record(f"{name} {tag}", f"{name}.cu", "", "bfloat16",
                      errs[name], cuda_ms(torch, fn, 5),
                      cuda_ms(torch, plain, 2), lib, nb, flops, peaks)
        records[name].setdefault("by_shape", {})["kw128"] = dict(
            _sub(rec), body="loops")
    del q, kv, dout, bh, bw, out, lse, args, got, dkv
    torch.cuda.empty_cache()


def _ft_batch(torch, b, size=1024, grid=64):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    images = torch.rand(b, size, size, 3, generator=gen, device="cuda")
    mask = torch.zeros(b, grid, grid, dtype=torch.bool, device="cuda")
    mask[0, 20:36, 24:40] = True                  # a nodule on the grid
    if b > 1:
        mask[1, 30:50, 10:26] = True
    labels = torch.eye(2, device="cuda")[torch.arange(b, device="cuda") % 2]
    return images, mask, labels


def finetune_phase(torch, A, ft, backbone="medsam", precision="fast",
                   per_step=STEP_LAUNCHES):
    """A fine-tuning main path: ``FineTuner`` at full width and depth,
    batch 2, 5 steps on a fixed batch, the launches of every step held to
    ``per_step``. SAM ViT-B/16 @1024 ``fast`` runs K1/K4/K5, ``parity``
    K6; DINOv2 ViT-B/14 @518 ``fast`` runs K5 in kv_len mode, ``parity``
    K6 in kv_len mode."""
    tuner = ft.FineTuner(ft.FineTuneConfig(backbone=backbone,
                                           precision=precision))
    state = tuner.init(seed=SEED)
    cfg = tuner.backbone_cfg
    batch = _ft_batch(torch, 2, cfg.image_size, cfg.grid)
    before = {k: p.detach().clone()
              for k, p in state["model"].named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    times, losses = [], []
    for _ in range(FT_STEPS):
        t0 = time.perf_counter()
        state, loss, logits = tuner.step(state, *batch)
        losses.append(float(loss))                 # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(A.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in state["model"].named_parameters())
    # steps 1-2 allocate the optimizer state and warm the allocator
    steady = sum(times[2:]) / (len(times) - 2)
    log(f"fine-tune {cfg.name} {precision} B=2, {FT_STEPS} steps: ms per "
        f"step {', '.join(f'{t * 1e3:.2f}' for t in times)}; steady (steps "
        f"3-{FT_STEPS}) {steady * 1e3:.2f} ms = {2 / steady:.2f} img/s; "
        f"peak memory {peak / 2 ** 30:.3f} GiB; losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; max parameter move "
        f"{moved:.3e}; launches {counts}")
    expect = {k: FT_STEPS * per_step.get(k, 0) for k in A.LAUNCHES}
    if counts != expect:
        raise AssertionError(f"fine-tune launches {counts} != {expect}")
    if not all(np.isfinite(losses)) or not moved > 0 or \
            tuple(logits.shape) != (2, 2):
        raise AssertionError("fine-tuning: non-finite loss or no update")
    return counts


# Per-leaf gradient limits of the checks against plain attention:
# max(rel · the leaf's max |grad|, floor). ``fast`` as the JAX package's
# tests/test_finetune.py holds its fused path to its oracle; ``parity``
# (fp32 on both sides, the sum order alone) from the gap measured on an
# H100 SXM: worst leaf 1.11e-5 of its max |grad| (blocks.5.attn.rel_pos_w),
# median 2.25e-6, no floor.
GRAD_LIMITS = {"fast": (0.05, 5e-4), "parity": (2e-5, 0.0)}


def grad_check_phase(torch, ft, precision="fast"):
    """One step's gradients at B=1 on SAM ViT-B/16 @1024: the trainable
    kernels (``fast``: K1/K4/K5; ``parity``: K6) vs the same weights
    through plain attention under torch autograd, per leaf
    |diff| <= max(rel · max |grad|, floor) (``GRAD_LIMITS``)."""
    rel, floor = GRAD_LIMITS[precision]
    tuner = ft.FineTuner(ft.FineTuneConfig(backbone="medsam",
                                           precision=precision))
    batch = [t[:1] for t in _ft_batch(torch, 1)]
    grads = {}
    for use_flash in (True, False):
        model = tuner.build_model(use_flash=use_flash).init_random(SEED)
        model = model.cuda()
        loss, _ = tuner.backward(model, *batch)     # the steps' backward
        grads[use_flash] = {k: p.grad.float()
                            for k, p in model.named_parameters()}
        del model, loss
        torch.cuda.empty_cache()
    worst, worst_name, floored, rels = 0.0, "", 0, []
    for name, ref in grads[False].items():
        scale = ref.abs().max().item()
        tol = max(rel * scale, floor)
        floored += tol > rel * scale
        err = (grads[True][name] - ref).abs().max().item()
        ratio = err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))
        if ratio > worst or not worst_name:
            worst, worst_name = ratio, name
        if scale > 0:
            rels.append(err / scale)
    rels.sort()
    log(f"gradient check {precision} B=1, trainable kernels vs plain "
        f"attention: {len(grads[False])} leaves, worst err/limit "
        f"{worst:.3f} ({worst_name}), err / leaf max |grad|: worst "
        f"{rels[-1]:.3e}, median {rels[len(rels) // 2]:.3e}; {floored} "
        f"leaves under the {floor:g} floor")
    if not worst <= 1.0:
        raise AssertionError(f"gradients disagree: {worst_name} at "
                             f"{worst:.3f} of its limit")


def k6_phase(torch, G, peaks):
    """Phase 10: the three K6 kernels (fp32) at the ``parity`` path's
    shapes, each output against its plain version; kernel, plain-version and
    library (fp32 SDPA with the dense bias, or the padding mask, as
    ``attn_mask``; forward, or the whole backward) times and the bound.
    A row's numbers are SAM's global shape's; ``by_shape`` holds all
    three."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    heads, d = 12, 64
    scale = d ** -0.5
    grad = "vit_deep_radiomics_tpu/ops/attention_grad.py"
    where = {"flash_attention_fwd": f"{grad}:56",
             "flash_attention_bwd_dq": f"{grad}:186",
             "flash_attention_bwd_dkv": f"{grad}:266"}
    rows = {n: {} for n in K6_NAMES}
    for shape, (b, s, kh, kw, kv_len) in K6_SHAPES.items():
        def rand(*sh, sc=1.0):
            return torch.randn(*sh, generator=gen, device="cuda") * sc

        q, k, v, dout = (rand(b, heads, s, d) for _ in range(4))
        bh = bw = kl = None
        if kh:
            bh, bw = rand(b, heads, s, kh, sc=0.3), rand(b, heads, s, kw,
                                                          sc=0.3)
        n_keys = kv_len or s
        if kv_len:
            kl = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
            key = torch.arange(s, device="cuda")
            mask = torch.zeros(b, heads, s, s, device="cuda").masked_fill(
                key >= n_keys, float("-inf"))
        else:
            mask = (bh[..., :, None] + bw[..., None, :]).reshape(
                b, heads, s, s)
        args, pairs = (q, k, v, bh, bw, kl), b * heads * s * n_keys * d
        iters = 20 if s < 1000 else 5
        tag = f"[{shape}]"

        def row(name, err, fn, plain, lib, nb, flops):
            ms = cuda_ms(torch, fn, iters)
            plain_ms = cuda_ms(torch, plain, 2)
            rows[name][shape] = _record(
                f"{name} {tag}", f"{name}.cu", where[name], "float32", err,
                ms, plain_ms, lib, nb, flops, peaks)

        out, lse = G.flash_attention_fwd(*args, scale=scale)
        torch.cuda.synchronize()
        err = _check_outputs(
            torch, f"flash_attention_fwd {tag}", [out, lse],
            G.flash_attention_fwd_plain(*args, scale=scale), ["out", "lse"],
            0.0, [K6_ATOL["flash_attention_fwd"], K6_ATOL["lse"]])
        row("flash_attention_fwd", err,
            lambda: G.flash_attention_fwd(*args, scale=scale),
            lambda: G.flash_attention_fwd_plain(*args, scale=scale),
            _sdpa_ms(torch, q, k, v, mask, scale),
            _nbytes(*args, out, lse), 4.0 * pairs)

        rest = (dout, lse, G.flash_attention_delta(out, dout))
        lib = _sdpa_ms(torch, q, k, v, mask, scale, dout, mask_grad=bool(kh))
        for name, plain_fn, labels, flops in (
                ("flash_attention_bwd_dq", G.flash_attention_bwd_dq_plain,
                 ("dq", "dbias_h", "dbias_w"), 6.0 * pairs),
                ("flash_attention_bwd_dkv", G.flash_attention_bwd_dkv_plain,
                 ("dk", "dv"), 8.0 * pairs)):
            fn = getattr(G, name)
            got = fn(*args, *rest, scale=scale)
            torch.cuda.synchronize()
            ref = plain_fn(*args, *rest, scale=scale)
            keep = [i for i, r in enumerate(ref) if r is not None]
            err = _check_outputs(
                torch, f"{name} {tag}", [got[i] for i in keep],
                [ref[i] for i in keep], [labels[i] for i in keep], 0.0,
                K6_ATOL[name])
            del ref
            row(name, err, lambda: fn(*args, *rest, scale=scale),
                lambda: plain_fn(*args, *rest, scale=scale), lib,
                _nbytes(*args, *rest, *got), flops)
            del got
        del q, k, v, dout, bh, bw, kl, mask, args, out, lse, rest
        torch.cuda.empty_cache()
    log("library yardstick of both K6 backward kernels: the whole fp32 SDPA "
        "backward (dq, dk, dv and, with a bias, the mask gradient)")
    records = {}
    for name, by in rows.items():
        rec = dict(by["sam_global"], name=name,
                   max_abs_err=max(r["max_abs_err"] for r in by.values()))
        rec["by_shape"] = {
            shape: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
            for shape, r in by.items()}
        records[name] = rec
    return records


def kv_len_phase(torch, A, G, peaks):
    """Phase 11: K2 and the three K5 kernels in kv_len mode at DINOv2
    ViT-B/14 @518's padded shape (1536 tokens, 1370 valid, 12 heads of 64,
    bf16), each at the batch of the path that runs it (K2: the inference
    forward's 4; K5: fine-tuning's 2) and against its plain version; times,
    library (bf16 SDPA with the padding mask), bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    s, n, heads, d = DINO_PADDED, DINO_TOKENS, 12, 64
    c, scale, dt, rtol = heads * d, d ** -0.5, torch.bfloat16, 2.0 ** -7

    def inputs(b):
        """q, kv, dout, kv_len, the padding mask, the per-head views."""
        q, kv, dout = (torch.randn(b, s, w, generator=gen,
                                   device="cuda").to(dt)
                       for w in (c, 2 * c, c))
        kl = torch.full((b,), n, dtype=torch.int32, device="cuda")
        key = torch.arange(s, device="cuda")
        mask = torch.zeros(b, heads, s, s, device="cuda",
                           dtype=dt).masked_fill(key >= n, float("-inf"))
        views = [_heads_of(t, 1, s, heads)
                 for t in (q, kv[..., :c], kv[..., c:], dout)]
        return q, kv, dout, kl, mask, views, b * heads * s * n * d

    kw = dict(num_heads=heads, scale=scale)
    k2 = "vit_deep_radiomics_tpu/ops/attention.py:654"
    grad = "vit_deep_radiomics_tpu/ops/attention_grad.py"
    records = {}

    def row(name, src, replaces, err, fn, plain, lib, nb, flops):
        rec = _record(f"{name}_kv_len", src, replaces, "bfloat16", err,
                      cuda_ms(torch, fn, 10), cuda_ms(torch, plain, 3), lib,
                      nb, flops, peaks)
        records[rec["name"]] = rec

    q, kv, _, kl, mask, (qh, kh_, vh, _), pairs = inputs(DINO_FWD_BATCH)
    out = A.fused_global_attention(q, kv, None, None, kl, **kw)
    torch.cuda.synchronize()
    err = _check_outputs(
        torch, f"fused_global_attention [kv_len, B={DINO_FWD_BATCH}]", [out],
        [A.fused_global_attention_plain(q, kv, None, None, kl, **kw)],
        ["out"], rtol, KV_ATOL["fused_global_attention"])
    row("fused_global_attention", "fused_global_attention.cu", k2, err,
        lambda: A.fused_global_attention(q, kv, None, None, kl, **kw),
        lambda: A.fused_global_attention_plain(q, kv, None, None, kl, **kw),
        _sdpa_ms(torch, qh, kh_, vh, mask, scale), _nbytes(q, kv, kl, out),
        4.0 * pairs)
    del q, kv, kl, mask, qh, kh_, vh, out
    torch.cuda.empty_cache()

    q, kv, dout, kl, mask, (qh, kh_, vh, doh), pairs = inputs(2)
    tag = "[kv_len, B=2]"
    _k5_fwd_route(G, q, kv, None, None, kl, heads, "kv_len", tag)
    out, lse = G.global_attention_fwd_lse(q, kv, None, None, kl, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = G.global_attention_fwd_lse_plain(q, kv, None, None,
                                                        kl, **kw)
    err = max(_check_outputs(torch, f"global_attention_fwd_lse {tag}",
                             [out], [ref_out], ["out"], rtol,
                             KV_ATOL["global_attention_fwd_lse"]),
              _check_outputs(torch, f"global_attention_fwd_lse {tag}",
                             [lse], [ref_lse], ["lse"], 0.0, KV_ATOL["lse"]))
    del ref_out, ref_lse
    row("global_attention_fwd_lse", "global_attention_fwd_lse.cu",
        f"{grad}:1068", err,
        lambda: G.global_attention_fwd_lse(q, kv, None, None, kl, **kw),
        lambda: G.global_attention_fwd_lse_plain(q, kv, None, None, kl, **kw),
        _sdpa_ms(torch, qh, kh_, vh, mask, scale),
        _nbytes(q, kv, kl, out, lse), 4.0 * pairs)

    args = (q, kv, None, None, kl, dout, lse,
            G.attention_delta(out, dout, heads))
    lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale, doh, mask_grad=False)
    _k5_bwd_routes(G, args, heads, tag)
    dq = G.global_attention_bwd_dq(*args, **kw)[0]
    dkv = G.global_attention_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    err = _check_outputs(
        torch, f"global_attention_bwd_dq {tag}", [dq],
        [G.global_attention_bwd_dq_plain(*args, **kw)[0]], ["dq"], rtol,
        KV_ATOL["global_attention_bwd_dq"])
    row("global_attention_bwd_dq", "global_attention_bwd_dq.cu",
        f"{grad}:1168", err, lambda: G.global_attention_bwd_dq(*args, **kw),
        lambda: G.global_attention_bwd_dq_plain(*args, **kw), lib,
        _nbytes(*args, dq), 6.0 * pairs)
    err = _check_outputs(
        torch, f"global_attention_bwd_dkv {tag}", [dkv],
        [G.global_attention_bwd_dkv_plain(*args, **kw)], ["dkv"], rtol,
        KV_ATOL["global_attention_bwd_dkv"])
    if dkv[:, n:].any():
        raise AssertionError("K5 dkv: padded keys got a gradient")
    row("global_attention_bwd_dkv", "global_attention_bwd_dkv.cu",
        f"{grad}:1255", err, lambda: G.global_attention_bwd_dkv(*args, **kw),
        lambda: G.global_attention_bwd_dkv_plain(*args, **kw), lib,
        _nbytes(*args, dkv), 8.0 * pairs)
    _k5_chain(torch, G, (q, kv, None, None, kl), dout, (dq, None, None, dkv),
              heads, kw, "kv_len", tag)
    del q, kv, dout, mask, qh, kh_, vh, doh, out, lse, args, dq, dkv
    torch.cuda.empty_cache()

    # K2 at DINOv2 ViT-L/14's and ViT-g/14's widths (16 and 24 heads: row
    # strides of 2C and 3C elements in the Hopper body's tensor maps)
    wide = records["fused_global_attention_kv_len"].setdefault("by_width",
                                                                {})
    for model, nh in DINO_WIDE.items():
        b, cw = DINO_FWD_BATCH, nh * d
        q, kv = (torch.randn(b, s, w, generator=gen, device="cuda").to(dt)
                 for w in (cw, 2 * cw))
        kl = torch.full((b,), n, dtype=torch.int32, device="cuda")
        kwh = dict(num_heads=nh, scale=scale)
        tag = f"[kv_len, {model}, {nh} heads, B={b}]"
        body = A.fused_global_attention_route(q, kv, None, None, kl, **kwh)
        log(f"kernel fused_global_attention {tag}: body {body}")
        if body != "hopper":
            raise AssertionError(f"K2 {tag} takes the {body} body")
        out = A.fused_global_attention(q, kv, None, None, kl, **kwh)
        torch.cuda.synchronize()
        err = _check_outputs(
            torch, f"fused_global_attention {tag}", [out],
            [A.fused_global_attention_plain(q, kv, None, None, kl, **kwh)],
            ["out"], rtol, KV_ATOL["fused_global_attention"])
        key = torch.arange(s, device="cuda")
        mask = torch.zeros(b, nh, s, s, device="cuda", dtype=dt).masked_fill(
            key >= n, float("-inf"))
        views = [_heads_of(t, 1, s, nh) for t in (q, kv[..., :cw],
                                                  kv[..., cw:])]
        rec = _record(
            f"fused_global_attention {tag}", "fused_global_attention.cu", k2,
            "bfloat16", err,
            cuda_ms(torch, lambda: A.fused_global_attention(
                q, kv, None, None, kl, **kwh), 10),
            cuda_ms(torch, lambda: A.fused_global_attention_plain(
                q, kv, None, None, kl, **kwh), 3),
            _sdpa_ms(torch, *views, mask, scale), _nbytes(q, kv, kl, out),
            4.0 * b * nh * s * n * d, peaks)
        wide[model] = dict(_sub(rec), heads=nh, body=body)
        del q, kv, kl, out, mask, views
        torch.cuda.empty_cache()
    return records


def dinov2_forward_phase(torch, A, vit, precision):
    """DINOv2 ViT-B/14 @518 inference forward at ``DINO_FWD_BATCH`` (4)
    under ``fast``: every layer runs K2 in kv_len mode (1370 tokens padded
    to 1536)."""
    model = vit.ViTDense(vit.DINOV2_CONFIGS["dinov2_vitb14"],
                         policy=precision.FAST).init_random(SEED)
    model = model.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    images = torch.rand(DINO_FWD_BATCH, 518, 518, 3, generator=gen,
                        device="cuda")
    with torch.no_grad():
        model(images)                                 # warm-up
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        out = model(images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = dict(A.LAUNCHES)
    log(f"forward dinov2_vitb14 fast B={DINO_FWD_BATCH}: {dt * 1e3:.2f} ms "
        f"({DINO_FWD_BATCH / dt:.2f} img/s), launches {counts}, out "
        f"{tuple(out.shape)}")
    if counts != dict(dict.fromkeys(A.LAUNCHES, 0),
                      fused_global_attention=12):
        raise AssertionError(f"DINOv2 launches per forward: {counts}")
    if tuple(out.shape) != (DINO_FWD_BATCH, 37, 37, 768) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("DINOv2 forward output is not finite or of "
                             "the expected shape")
    del model, out
    torch.cuda.empty_cache()
    return counts


def _sub(rec):
    return {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}


def _k3_dense(torch, q, k, v, bh, bw, kl, grid, win):
    """SDPA's inputs for K3's function: head-major q/k/v (one batch entry
    per window in window mode) and the dense additive mask, the decomposed
    bias with -inf at every key K3 masks; also the valid keys of a row,
    which are as many as the valid queries of a row (or of a window): the
    tokens the path keeps before its padding."""
    b, heads, s, _ = q.shape
    if win:
        n = s // win

        def split(t):
            return t.reshape(b, heads, n, win, t.shape[-1]).transpose(1, 2) \
                .reshape(b * n, heads, win, t.shape[-1])

        q, k, v, bh, bw = map(split, (q, k, v, bh, bw))
    sk = k.shape[2]
    key = torch.arange(sk, device=q.device)
    valid = torch.ones(sk, dtype=torch.bool, device=q.device)
    mask = torch.zeros(*q.shape[:3], sk, device=q.device, dtype=q.dtype)
    if bh is not None:
        kw = bw.shape[-1]
        mask = (bh[..., :, None] + bw[..., None, :]).reshape(mask.shape)
        if grid is not None:
            valid = (key // kw < grid[0]) & (key % kw < grid[1])
    if kl is not None:
        valid = valid & (key < int(kl[0]))      # one kv_len for the batch
    mask = mask.masked_fill(~valid, float("-inf"))
    return (q.contiguous(), k.contiguous(), v.contiguous(),
            mask.contiguous(), int(valid.sum()))


def k3_phase(torch, A, peaks):
    """Phase 15: K3 at its paths' shapes against its plain version; kernel,
    plain, SDPA (the dense bias with K3's masked keys at -inf as
    ``attn_mask``) times and the bound, which counts only the valid keys
    and the query rows the path keeps. The row is SAM @768's global shape
    in bf16, the main path's: the 2304 query rows ``WindowedAttention.
    _flash`` passes against the 48 x 64 padded key grid; ``fp32`` and
    ``by_shape`` hold the others, among them the same call with the queries
    padded to 3072 as JAX pads them (``sam768_padded``, the bound the same).
    The bodies: the Hopper kernel for bf16 at @768 and in ``kv_len`` mode
    (no bias: 64-key tiles up to kv_len), the register-tiled forward for
    fp32, the loops for the ``window`` shape. That shape checks the
    ``window_tokens`` mode, which only ``WindowedAttention``'s
    ``window_group`` > 1 reaches (JAX's default is 1, and no entry point
    of either package sets it), so no path of the port runs it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    heads, d = 12, 64
    scale = d ** -0.5
    bf16, fp32 = torch.bfloat16, torch.float32
    # B, Sq, Sk, Kh, Kw, kv_grid, kv_len, window_tokens, dtypes
    shapes = {"sam768_global": (4, 2304, 3072, 48, 64, (48, 48), None, None,
                                (bf16, fp32)),
              "sam768_padded": (4, 3072, 3072, 48, 64, (48, 48), None, None,
                                (bf16,)),
              "kv_len": (4, 1370, 1536, 0, 0, None, 1370, None, (bf16,)),
              "window": (25, 1024, 1024, 16, 16, (14, 14), None, 256,
                         (bf16,))}
    bodies = {"sam768_global": "hopper", "sam768_padded": "hopper",
              "kv_len": "hopper", "window": "loops"}
    rows = {}
    for shape, (b, sq, sk, kh, kw, grid, kv_len, win,
                dtypes) in shapes.items():
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]

            def rand(*sh, sc=1.0):
                return (torch.randn(*sh, generator=gen, device="cuda")
                        * sc).to(dtype)

            q = rand(b, heads, sq, d)
            k, v = (rand(b, heads, sk, d) for _ in range(2))
            bh = bw = kl = None
            if kh:
                bh, bw = rand(b, heads, sq, kh, sc=0.3), rand(b, heads, sq,
                                                               kw, sc=0.3)
            if kv_len:
                kl = torch.full((b,), kv_len, dtype=torch.int32,
                                device="cuda")
            # JAX's blocks divide the lengths: one block a call
            opts = dict(kv_grid=grid, window_tokens=win, block_q=sq,
                        block_k=sk)

            def kern():
                return A.flash_attention(q, k, v, bh, bw, kl, **opts)

            def plain():
                return A.flash_attention_plain(q, k, v, bh, bw, kl,
                                               kv_grid=grid,
                                               window_tokens=win,
                                               scale=scale)

            body = A.flash_attention_route(q, k, v, bh, bw, kl, **opts)
            want = "tiled" if dtype == fp32 else bodies[shape]
            log(f"kernel flash_attention [{shape}, {dname}]: body {body}")
            if body != want:
                raise AssertionError(f"flash_attention {shape} {dname} takes "
                                     f"the {body} body, not {want}")
            out = kern()
            torch.cuda.synchronize()
            tag = f"flash_attention [{shape}, {dname}]"
            err = _check_outputs(torch, tag, [out], [plain()], ["out"],
                                 RTOL[dname], K3_ATOL[dname])
            qh, kh_, vh, mask, n_valid = _k3_dense(torch, q, k, v, bh, bw,
                                                   kl, grid, win)
            lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale)
            del qh, kh_, vh, mask
            # the query rows the path keeps: as many as the valid keys of
            # a row (or of a window)
            rows[shape, dname] = _record(
                tag, "flash_attention.cu",
                "vit_deep_radiomics_tpu/ops/attention.py:87", dname, err,
                cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 2), lib,
                _nbytes(q, k, v, bh, bw, kl, out),
                4.0 * b * heads * (sq // (win or sq)) * n_valid * n_valid * d,
                peaks)
            rows[shape, dname]["body"] = body
            del q, k, v, bh, bw, kl, out
            torch.cuda.empty_cache()
    rec = dict(rows["sam768_global", "bfloat16"], name="flash_attention")
    rec["fp32"] = _sub(rows["sam768_global", "float32"])
    rec["fp32_body"] = rows["sam768_global", "float32"]["body"]
    rec["by_shape"] = {f"{shape} {dname}": _sub(r)
                       for (shape, dname), r in rows.items()}
    return rec


def k7_phase(torch, peaks):
    """Phase 16: K7 at the rows of its paths (``K7_SHAPES``): SAM ViT-B/16's
    at batch 4 (16384 x 768, hidden 3072), DINOv2 ViT-B/14's (4 x 1370,
    with layerscale) and DINOv2 ViT-g/14's (4 x 1370 x 1536, hidden 6144,
    with layerscale), bf16 with the weights in the torch Linear layout,
    against its plain version, its C entry asked which body it takes; the
    library time is the unfused PyTorch path on the same bf16 inputs. The
    row is SAM's shape, the main path's."""
    import torch.nn.functional as F
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    dt, eps = torch.bfloat16, 1e-6

    def rand(*sh, sc=1.0, dtype=torch.float32):
        return (torch.randn(*sh, generator=gen, device="cuda")
                * sc).to(dtype)

    weights = {}
    rows = {}
    for shape, (b, s, c, hidden, with_ls, want) in K7_SHAPES.items():
        if (c, hidden) not in weights:
            weights[(c, hidden)] = (
                rand(hidden, c, sc=c ** -0.5, dtype=dt),       # lin1.weight
                rand(c, hidden, sc=hidden ** -0.5, dtype=dt),  # lin2.weight
                rand(hidden, sc=0.02), rand(c, sc=0.02),
                1.0 + rand(c, sc=0.1), rand(c, sc=0.1),
                0.1 + rand(c, sc=0.02))
        w1, w2, b1, b2, ln_s, ln_b, ls = weights[(c, hidden)]
        x = rand(b, s, c, dtype=dt)
        lsv = ls if with_ls else None
        args = (x, ln_s, ln_b, w1.t(), b1, w2.t(), b2, lsv)

        def kern():
            return M.fused_ln_mlp_residual(*args, eps=eps)

        def plain():
            return M.fused_ln_mlp_residual_plain(*args, eps=eps)

        body = M.fused_ln_mlp_residual_route(*args)
        if body != want:
            raise AssertionError(f"K7 at {shape}'s rows takes the {body} "
                                 f"body, not the {want} one")
        out = kern()
        torch.cuda.synchronize()
        tag = f"fused_ln_mlp_residual [{shape}, {b}x{s} rows, C {c}, {body}]"
        err = _check_outputs(torch, tag, [out], [plain()], ["out"],
                             RTOL["bfloat16"], K7_ATOL)
        p = [None if t is None else t.to(dt) for t in (ln_s, ln_b, b1, b2,
                                                      lsv)]

        def unfused():
            y = F.layer_norm(x, (c,), p[0], p[1], eps)
            o = F.linear(F.gelu(F.linear(y, w1, p[2]), approximate="tanh"),
                         w2, p[3])
            return x + (o * p[4] if with_ls else o)

        rows[shape] = _record(
            tag, "fused_ln_mlp_residual.cu",
            "vit_deep_radiomics_tpu/ops/mlp_fused.py:47", "bfloat16", err,
            cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 3),
            (cuda_ms(torch, unfused, 10), None),
            _nbytes(x, ln_s, ln_b, w1, b1, w2, b2, lsv, out),
            4.0 * b * s * c * hidden, peaks,
            library="unfused PyTorch bf16: LayerNorm, 2 cuBLAS GEMMs, "
                    "tanh GELU, residual")
        rows[shape]["body"] = body
        del x, args, out
        torch.cuda.empty_cache()
    rec = dict(rows["sam"], name="fused_ln_mlp_residual")
    rec["by_shape"] = {shape: dict(_sub(r), body=r["body"])
                       for shape, r in rows.items()}
    return rec


# The backbone's five per-block contractions under `int8`: (K, N)
K8_SHAPES = {"q": (768, 768), "kv": (768, 1536), "proj": (768, 768),
             "lin1": (768, 3072), "lin2": (3072, 768)}
# K8's rows at batch 4: the global layers' 4 x 4096 tokens, the windowed
# layers' 100 windows x 196 tokens padded to 128 rows
K8_ROWS = (16384, 19712)


def k8_phase(torch, Q, peaks, int8_peak):
    """Phase 17: K8 at the five backbone contractions at batch 4, exactly
    equal to its plain version (float64 on the card: |acc| <= 127^2 * 3072
    < 2^53); ``torch._int_mm`` as the library time, the bound against the
    int8 peak; then the rate probes. The row is the MLP's first layer at
    M = 16384 (the largest call)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rows = {}
    for m in K8_ROWS:
        for label, (k, n) in K8_SHAPES.items():
            x = torch.randint(-127, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            w_kn = w.t().contiguous()               # _int_mm's (K, N)
            got = Q.int8_matmul_nk(x, w)
            torch.cuda.synchronize()
            ref = Q.int8_matmul_plain(x, w_kn)
            err = (got.double() - ref.double()).abs().max().item()
            tag = f"int8_matmul [M={m} {label} {k}x{n}]"
            log(f"kernel {tag}: max_abs_err {err:g} (exact required), "
                f"dtype {got.dtype}")
            if got.dtype != torch.int32 or not torch.equal(got, ref):
                raise AssertionError(f"{tag} differs from the exact product")
            rows[m, label] = _record(
                tag, "int8_matmul.cu",
                "vit_deep_radiomics_tpu/ops/quant.py:193", "int8", err,
                cuda_ms(torch, lambda: Q.int8_matmul_nk(x, w), 20),
                cuda_ms(torch, lambda: Q.int8_matmul_plain(x, w_kn), 3),
                (cuda_ms(torch, lambda: torch._int_mm(x, w_kn), 20), None),
                _nbytes(x, w, got), 2.0 * m * k * n, peaks,
                op_peak=int8_peak, library="torch._int_mm")
            del x, w, w_kn, got, ref
        torch.cuda.empty_cache()
    rates = {}
    for label, (k, n) in K8_SHAPES.items():
        r = Q.int8_kernel_rate_ratio(K8_ROWS[0], k, n)
        rates[label] = {key: r[key] for key in ("tops", "k8_vs_bf16",
                                                "k8_vs_int_mm",
                                                "int_mm_vs_bf16")}
        log(f"int8 rate probe {label} ({K8_ROWS[0]}x{k} @ {k}x{n}, 8 "
            f"weights per call): TOP/s " + ", ".join(
                f"{p} {t:.1f}" for p, t in r["tops"].items())
            + f"; K8/bf16 {r['k8_vs_bf16']:.3f}, K8/_int_mm "
            f"{r['k8_vs_int_mm']:.3f}, _int_mm/bf16 "
            f"{r['int_mm_vs_bf16']:.3f}")
    guard = Q.int8_matmul_rate_ratio()
    log(f"int8 guard probe (the extraction CLI's, 4096x768 @ 768x3072): "
        f"int8/bf16 rate ratio {guard:.3f}")
    rec = dict(rows[K8_ROWS[0], "lin1"], name="int8_matmul")
    rec["by_shape"] = {f"M={m} {label}": _sub(r)
                       for (m, label), r in rows.items()}
    # an `int8` forward's 60 launches: the five products of each of the 4
    # global blocks (M = 16384) and of the 8 windowed ones (M = 19712)
    blocks = dict(zip(K8_ROWS, (4, 8)))
    for key in ("ms", "bound_ms"):
        rec[f"forward_{key}"] = sum(n * rows[m, label][key]
                                    for m, n in blocks.items()
                                    for label in K8_SHAPES)
    log(f"kernel int8_matmul over an int8 forward's 60 launches: ms "
        f"{rec['forward_ms']:.4f} bound_ms {rec['forward_bound_ms']:.4f}")
    rec["rate_probe"] = rates
    rec["guard_ratio"] = guard
    return rec


def _timed_forward(torch, A, model, images):
    """A warm-up forward, then one timed with the launch counters set to 0
    just before it: (output, seconds, counts)."""
    with torch.no_grad():
        model(images)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        out = model(images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return out, dt, dict(A.LAUNCHES)


def _min_cosine(a, b):
    """The smallest per-position cosine over the channel axis."""
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()


def paths_phase(torch, A, vit, precision, tex, syn):
    """Phase 18: the new forward paths of full-width SAM ViT-B/16 at batch
    4 with their launch counts asserted, each held at batch 1 to an oracle
    on the same weights, then one ``extract_volume`` per new path on one
    synthetic patient (CT and PET). Returns the launches per forward of
    each path, and under "parity_768" the `parity` @768 B=4 record."""
    import dataclasses

    cfg = vit.SAM_VIT_B
    cfg768 = dataclasses.replace(cfg, image_size=768)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    images = torch.rand(4, 1024, 1024, 3, generator=gen, device="cuda")
    images768 = torch.rand(4, 768, 768, 3, generator=gen, device="cuda")
    state = vit.ViTDense(cfg, policy=precision.FAST).init_random(
        SEED).state_dict()
    state768 = vit.ViTDense(cfg768, policy=precision.FAST).init_random(
        SEED).state_dict()
    counts = {}

    def build(c, policy, st, use_flash=True):
        m = vit.ViTDense(c, policy=policy, use_flash=use_flash)
        m.load_state_dict(st)              # cast to the policy's dtype
        return m.cuda().eval()

    def one(model, imgs):
        with torch.no_grad():
            return model(imgs[:1]).float()

    def drive(label, model, imgs):
        out, dt, n = _timed_forward(torch, A, model, imgs)
        b, grid = imgs.shape[0], imgs.shape[1] // 16
        log(f"forward {label} B={b}: {dt * 1e3:.2f} ms ({b / dt:.2f} "
            f"img/s), launches {n}")
        expect = dict(dict.fromkeys(A.LAUNCHES, 0), **PATH_LAUNCHES[label])
        if n != expect:
            raise AssertionError(f"{label}: launches per forward {n} != "
                                 f"{expect}")
        if tuple(out.shape) != (b, grid, grid, 256) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label} forward output is not finite or "
                                 "of the expected shape")
        counts[label] = n

    def hold(label, got, ref, atol):
        diff = (got - ref).abs()
        err = diff.max().item()
        gap = (diff - 2.0 ** -7 * ref.abs()).max().item()
        log(f"forward {label} B=1 vs its oracle: max abs err {err:.3e} on "
            f"max |x| {ref.abs().max().item():.3f}; gap beyond one bf16 step "
            f"{gap:.3e} (limit {atol:.1e})")
        if not gap <= atol:
            raise AssertionError(f"{label} forward disagrees with its "
                                 f"oracle: gap {gap} > {atol}")

    # inference (bf16 parameters) vs `fast` on the same bf16-rounded weights
    model = build(cfg, precision.INFERENCE, state)
    drive("inference", model, images)
    got = one(model, images)
    del model
    state_bf = {k: v.to(torch.bfloat16).float() for k, v in state.items()}
    model = build(cfg, precision.FAST, state_bf)
    hold("inference", got, one(model, images), PATH_ATOL["inference"])
    del model, state_bf

    # int8 (K8) vs the `parity` plain-attention forward, JAX's criterion
    model = build(cfg, precision.INT8, state)
    drive("int8", model, images)
    got = one(model, images)
    del model
    model = build(cfg, precision.PARITY, state, use_flash=False)
    cos = _min_cosine(got, one(model, images))
    del model
    log(f"forward int8 B=1 vs parity plain attention: smallest per-position "
        f"cosine {cos:.6f} (limit > {INT8_MIN_COSINE})")
    if not cos > INT8_MIN_COSINE:
        raise AssertionError(f"int8 forward: cosine {cos}")

    # fast + VDR_FUSED_MLP=1 (K7) vs the unfused fast forward
    model = build(cfg, precision.FAST, state)
    os.environ["VDR_FUSED_MLP"] = "1"
    try:
        drive("fused_mlp", model, images)
        got = one(model, images)
    finally:
        os.environ.pop("VDR_FUSED_MLP")
    hold("fused_mlp", got, one(model, images), PATH_ATOL["fused_mlp"])
    del model
    torch.cuda.empty_cache()

    # fast @768 (K3 in the global layers); parity at B=4 (K3 in fp32: host
    # and device ms), and fused vs plain at B=1
    model = build(cfg768, precision.FAST, state768)
    drive("fast_768", model, images768)
    del model
    outs = {}
    for use_flash in (True, False):
        model = build(cfg768, precision.PARITY, state768, use_flash)
        if use_flash:
            counts["parity_768"] = parity_forward_b4(
                torch, A, model, images768, "parity @768",
                PATH_LAUNCHES["fast_768"])
        outs[use_flash] = one(model, images768)
        del model
    err = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    log(f"forward parity @768 B=1, kernels (K3, K1) vs plain attention: max "
        f"abs err {err:.3e} on outputs of max |x| {scale:.3f}")
    if not err <= 1e-4 * max(1.0, scale):
        raise AssertionError(f"parity @768 forward disagrees: {err}")
    del outs, images, images768
    torch.cuda.empty_cache()

    # one extract_volume run per new path: one patient, CT and PET
    patient = next(iter(syn.synthetic_cohort(
        n_patients=1, seed=SEED, height=256, width=256).values()))
    runs = {"int8": (dict(precision="int8"), state, {}),
            "fused_mlp": (dict(precision="fast"), state,
                          {"VDR_FUSED_MLP": "1"}),
            "fast_768": (dict(precision="fast", image_size=768), state768,
                         {})}
    for label, (conf, st, env) in runs.items():
        ex = tex.DenseExtractor(tex.ExtractionConfig(**conf), state_dict=st)
        os.environ.update(env)
        try:
            warm = syn.synthetic_volume(np.random.default_rng(9), 256, 256,
                                        2, modality="pet")
            ex.extract_volume(warm[0], warm[1], "pet")      # warm-up
            forwards = [0]
            ex.model.register_forward_hook(
                lambda *_: forwards.__setitem__(0, forwards[0] + 1))
            torch.cuda.synchronize()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            n_images = 0
            for modality in ("ct", "pet"):
                vol, mask, _ = patient[modality]
                feats, _, _ = ex.extract_volume(vol, mask, modality)
                n_images += len(feats)
                if not all(f.ndim == 3 and f.shape[2] == 256
                           and np.isfinite(f).all() for f in feats):
                    raise AssertionError(f"{label} extraction: bad crop")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            for key in env:
                os.environ.pop(key)
        n = dict(A.LAUNCHES)
        expect = {k: forwards[0] * PATH_LAUNCHES[label].get(k, 0)
                  for k in A.LAUNCHES}
        log(f"extraction {label}: 1 patient x (CT, PET) at 256x256, "
            f"{n_images} images in {dt * 1e3:.1f} ms = {n_images / dt:.2f} "
            f"img/s; {forwards[0]} forwards, launches {n}")
        if n != expect or not n_images:
            raise AssertionError(f"{label} extraction launches {n} != "
                                 f"{expect}")
        del ex
        torch.cuda.empty_cache()
    return counts


def dinov2_extraction_phase(torch, A, vit, precision, tex, syn):
    """Phase 19: DINOv2 dense extraction at full width and depth, random
    weights from the seed, under ``fast`` (``DINO_PATHS``): ViT-L/14
    ``full`` @518 (a B=4 forward with host ms, device ms and idle share and
    K2's 24 launches asserted, held at batch 1 against the plain-attention
    forward on the same weights, then ``DenseExtractor.extract_volume`` on
    one synthetic patient, CT through HU→RGB and PET), ViT-L/14
    ``patch_embed`` @896 (the same extraction: no kernel launched, a 64 x
    64 x 1024 grid) and ViT-g/14 ``full`` @518 with ``VDR_FUSED_MLP=1`` (a
    B=4 forward with 40 K7 and 40 K2 launches, held at batch 1 against the
    unfused forward, one extraction). Returns each path's record."""
    from vit_deep_radiomics_tpu_torch.utils import profiling

    patient = next(iter(syn.synthetic_cohort(
        n_patients=1, seed=SEED, height=256, width=256).values()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    images = torch.rand(DINO_FWD_BATCH, 518, 518, 3, generator=gen,
                        device="cuda")
    records = {}

    def expect(launches, times=1):
        return {k: times * launches.get(k, 0) for k in A.LAUNCHES}

    def with_env(env, fn):
        os.environ.update(env)
        try:
            return fn()
        finally:
            for key in env:
                os.environ.pop(key)

    def forward(label, model, env, launches, width):
        """B=4: host ms after a warm-up, launches, device ms and idle
        share over traced forwards."""
        out, dt, n = with_env(env, lambda: _timed_forward(torch, A, model,
                                                          images))
        grid = images.shape[1] // 14
        if n != expect(launches):
            raise AssertionError(f"{label}: launches per forward {n}")
        if tuple(out.shape) != (DINO_FWD_BATCH, grid, grid, width) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label} forward output is not finite or "
                                 "of the expected shape")
        del out
        with torch.no_grad():
            res = with_env(env, lambda: profiling.trace_runs(
                lambda: model(images), 2, 6))
        log(f"forward {label} B={DINO_FWD_BATCH}: host {dt * 1e3:.3f} ms "
            f"({DINO_FWD_BATCH / dt:.2f} img/s); device "
            f"{res['device_ms']:.3f} ms a forward (wall {res['wall_ms']:.3f}"
            f" ms, idle share {res['idle_share']:.3f}); launches {n}")
        for row in res["top"]:
            log(f"  {row['ms']:9.3f} ms  {row['calls']:5.1f}x  {row['name']}")
        return {"host_ms": dt * 1e3, "img_s": DINO_FWD_BATCH / dt,
                "device_ms": res["device_ms"],
                "traced_wall_ms": res["wall_ms"],
                "idle_share": res["idle_share"], "launches": n}

    def hold(label, got, ref):
        atol = DINO_ATOL[label]
        diff = (got - ref).abs()
        err = diff.max().item()
        gap = (diff - 2.0 ** -7 * ref.abs()).max().item()
        log(f"forward {label} B=1 vs its oracle: max abs err {err:.3e} on "
            f"max |x| {ref.abs().max().item():.3f}; gap beyond one bf16 step "
            f"{gap:.3e} (limit {atol:.1e})")
        if not gap <= atol:
            raise AssertionError(f"{label} forward disagrees with its "
                                 f"oracle: gap {gap} > {atol}")
        return err

    def extract(label, ex, env, launches, width):
        """One patient, CT and PET, after a warm-up: ms, img/s and the
        launches (per forward as ``launches``)."""
        warm = syn.synthetic_volume(np.random.default_rng(9), 256, 256, 2,
                                    modality="pet")
        forwards = [0]

        def run():
            ex.extract_volume(warm[0], warm[1], "pet")      # warm-up
            ex.model.register_forward_hook(
                lambda *_: forwards.__setitem__(0, forwards[0] + 1))
            torch.cuda.synchronize()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            n_images = 0
            for modality in ("ct", "pet"):
                vol, mask, _ = patient[modality]
                feats, masks, meta = ex.extract_volume(vol, mask, modality)
                n_images += len(feats)
                if not (len(feats) == len(masks) == len(meta[0])) or not all(
                        f.ndim == 3 and f.shape[2] == width
                        and np.isfinite(f).all() for f in feats):
                    raise AssertionError(f"{label} extraction: bad crop")
            torch.cuda.synchronize()
            return n_images, time.perf_counter() - t0

        n_images, dt = with_env(env, run)
        n = dict(A.LAUNCHES)
        log(f"extraction {label}: 1 patient x (CT, PET) at 256x256, "
            f"{n_images} images in {dt * 1e3:.1f} ms = {n_images / dt:.2f} "
            f"img/s; {forwards[0]} forwards, launches {n}")
        if n != expect(launches, forwards[0]) or not n_images:
            raise AssertionError(f"{label} extraction launches {n}")
        return {"ms": dt * 1e3, "img_s": n_images / dt, "images": n_images,
                "forwards": forwards[0], "launches": n}

    state = name_of_state = None
    for label, (name, mode, env, launches) in DINO_PATHS.items():
        cfg = vit.DINOV2_CONFIGS[name]
        if name != name_of_state:
            state = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            state = vit.ViTDense(cfg, policy=precision.FAST).init_random(
                SEED).state_dict()
            name_of_state = name
            log(f"{name}: random weights from seed {SEED} in "
                f"{time.perf_counter() - t0:.1f} s")
        rec = {}
        if mode == "full":
            model = vit.ViTDense(cfg, policy=precision.FAST)
            model.load_state_dict(state)
            model = model.cuda().eval()
            rec["forward"] = forward(label, model, env, launches, cfg.width)
            with torch.no_grad():
                got = with_env(env, lambda: model(images[:1]).float())
                if env:      # the unfused forward of the same model
                    ref = model(images[:1]).float()
                else:        # plain attention on the same weights
                    plain = vit.ViTDense(cfg, policy=precision.FAST,
                                         use_flash=False)
                    plain.load_state_dict(state)
                    ref = plain.cuda().eval()(images[:1]).float()
                    del plain
            rec["b1_max_abs_err"] = hold(label, got, ref)
            del model, got, ref
            torch.cuda.empty_cache()
        ex = tex.DenseExtractor(tex.ExtractionConfig(
            model_name=name, dinov2_mode=mode, precision="fast"),
            state_dict=state)
        if mode == "patch_embed":
            with torch.no_grad():
                grid = tuple(ex.model(torch.zeros(1, 896, 896, 3,
                                                  device="cuda")).shape)
            log(f"extraction {label}: image {ex.image_size} px, feature map "
                f"{grid[1:]}")
            if ex.image_size != 896 or grid != (1, 64, 64, cfg.width):
                raise AssertionError(f"{label}: feature map {grid}")
        rec["extraction"] = extract(label, ex, env, launches, cfg.width)
        records[label] = rec
        del ex
        torch.cuda.empty_cache()
    del state, images
    torch.cuda.empty_cache()
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from vit_deep_radiomics_tpu_torch.core import precision
        from vit_deep_radiomics_tpu_torch.data import synthetic as syn
        from vit_deep_radiomics_tpu_torch.engine import extract as tex
        from vit_deep_radiomics_tpu_torch.models import vit
        from vit_deep_radiomics_tpu_torch.engine import finetune as ft
        from vit_deep_radiomics_tpu_torch.ops import attention as A
        from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
        from vit_deep_radiomics_tpu_torch.ops import quant as Q
        from vit_deep_radiomics_tpu_torch.utils import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port package is not next to this script "
              f"({exc})", file=sys.stderr)
        return 2

    # phases 18 and 19 set VDR_FUSED_MLP themselves; every other phase runs
    # without it
    os.environ.pop("VDR_FUSED_MLP", None)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    sku, peaks = peaks_for(name)
    log(f"card: {card} (peaks used for bounds: H100 {sku}, "
        f"{peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s bf16, "
        f"{peaks[2] / 1e12:.0f} TFLOP/s fp32)")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_logs = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(cuda_build.KERNEL_SOURCES)}")
    for src in NO_SPILL:
        notes = [ln.split(":", 1)[-1].strip()
                 for ln in build_logs[src].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"ptxas {src}: {' | '.join(notes) or 'built earlier, no log'}")
        if cuda_build.spill_bytes(build_logs[src]):
            raise AssertionError(f"{src} spills registers")
    for src in TILED_SOURCES:
        funcs = cuda_build.ptxas_functions(build_logs[src])
        tiled = {f: r for f, r in funcs.items() if "tiled_kernel" in f}
        log(f"ptxas {src} (tiled fp32 forward): " + " | ".join(
            f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
            for f, r in tiled.items()) + f"; the whole source "
            f"{cuda_build.spill_bytes(build_logs[src])} bytes spill")
        if build_logs[src] and (len(tiled) != 2 or any(
                r["spill"] for r in tiled.values())):
            raise AssertionError(f"{src}: the tiled fp32 forward's kernels "
                                 f"{tiled} spill or are missing")
    # K3's Hopper kernel: its three instances (48-key tiles with the bias,
    # 64-key tiles with and without) must show no spill
    hopper = {f: r for f, r in cuda_build.ptxas_functions(
        build_logs["flash_attention"]).items() if "hopper_kernel" in f}
    log("ptxas flash_attention (Hopper): " + " | ".join(
        f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
        for f, r in hopper.items()))
    if build_logs["flash_attention"] and (len(hopper) != 3 or any(
            r["spill"] for r in hopper.values())):
        raise AssertionError(f"flash_attention: the Hopper kernels {hopper} "
                             "spill or are missing")
    for src, n_hopper in HOPPER_SOURCES.items():
        blog = build_logs[src]
        hopper = {f: r for f, r in cuda_build.ptxas_functions(blog).items()
                  if "hopper_kernel" in f}
        serial = [ln.strip() for ln in blog.splitlines() if "C75" in ln]
        log(f"ptxas {src} (Hopper): " + " | ".join(
            f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
            for f, r in hopper.items()) + f"; C75xx lines: {len(serial)}")
        if blog and (len(hopper) != n_hopper or serial or any(
                r["spill"] for r in hopper.values())):
            raise AssertionError(f"{src}: the Hopper kernels {hopper} spill, "
                                 f"are missing or are serialised: {serial}")
    # K7 at C 1536 (DINOv2 ViT-g/14): the loops' 32-row instance keeps its
    # 192 output accumulators a thread in registers
    wide = {f: r for f, r in cuda_build.ptxas_functions(
        build_logs["fused_ln_mlp_residual"]).items()
        if "mlp_bf16_kernel" in f and "1536" in f}
    log("ptxas fused_ln_mlp_residual (C 1536 loop): " + " | ".join(
        f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
        for f, r in wide.items()))
    if build_logs["fused_ln_mlp_residual"] and (len(wide) != 1 or any(
            r["spill"] for r in wide.values())):
        raise AssertionError(f"fused_ln_mlp_residual: the C 1536 instance "
                             f"{wide} spills or is missing")

    records = kernel_phase(torch, A, peaks)
    state, parity_1024 = forward_phase(torch, A, vit, precision)
    records["fused_global_attention"]["parity_forward_1024"] = parity_1024
    counts = extraction_phase(torch, A, tex, syn, state)
    mask_phase(torch, syn)
    extraction_reference_phase(torch, tex, syn, state)
    sweep_phase(tex, syn, state)
    del state
    torch.cuda.empty_cache()
    records.update(train_kernel_phase(torch, A, G, peaks))
    ft_counts = finetune_phase(torch, A, ft)
    torch.cuda.empty_cache()
    grad_check_phase(torch, ft)
    torch.cuda.empty_cache()

    # launches of the path that runs each kernel: extraction for K1/K2,
    # fine-tuning for K4/K5
    for kname, rec in records.items():
        rec["launches"] = counts[kname] if counts[kname] else \
            ft_counts[kname]

    k6_records = k6_phase(torch, G, peaks)                     # phase 10
    kv_records = kv_len_phase(torch, A, G, peaks)              # phase 11
    parity_counts = finetune_phase(torch, A, ft, "medsam", "parity",
                                   PARITY_STEP_LAUNCHES)       # phase 12
    torch.cuda.empty_cache()
    dino_fast = finetune_phase(torch, A, ft, "dinov2_vitb14", "fast",
                               DINO_FAST_STEP_LAUNCHES)        # phase 13
    torch.cuda.empty_cache()
    dino_parity = finetune_phase(torch, A, ft, "dinov2_vitb14", "parity",
                                 PARITY_STEP_LAUNCHES)
    torch.cuda.empty_cache()
    dino_fwd = dinov2_forward_phase(torch, A, vit, precision)
    grad_check_phase(torch, ft, "parity")                      # phase 14

    # K6: SAM parity fine-tuning is its main path, DINOv2 parity its
    # kv_len path; K2/K5 in kv_len mode: the DINOv2 forward and fast steps
    for kname, rec in k6_records.items():
        rec["launches"] = parity_counts[kname]
        rec["launches_dinov2_parity"] = dino_parity[kname]
    for kname, rec in kv_records.items():
        base = kname[:-len("_kv_len")]
        rec["launches"] = dino_fwd[base] if base == \
            "fused_global_attention" else dino_fast[base]
    records.update(k6_records)
    records.update(kv_records)

    records["flash_attention"] = k3_phase(torch, A, peaks)     # phase 15
    records["fused_ln_mlp_residual"] = k7_phase(torch, peaks)  # phase 16
    records["int8_matmul"] = k8_phase(torch, Q, peaks,
                                      INT8_PEAKS[sku])         # phase 17
    torch.cuda.empty_cache()
    path_counts = paths_phase(torch, A, vit, precision, tex,
                              syn)                             # phase 18
    records["flash_attention"]["parity_forward_768"] = \
        path_counts.pop("parity_768")
    # K3: the @768 forward; K7: the fused-MLP forward; K8: the int8 forward
    for kname, path in (("flash_attention", "fast_768"),
                        ("fused_ln_mlp_residual", "fused_mlp"),
                        ("int8_matmul", "int8")):
        records[kname]["launches"] = path_counts[path][kname]
    torch.cuda.empty_cache()
    dino = dinov2_extraction_phase(torch, A, vit, precision, tex,
                                   syn)                        # phase 19
    # DINOv2 extraction's launches per forward: K2 (kv_len) at ViT-L/14's
    # 24 layers, K7 at ViT-g/14's 40 (C 1536)
    records["fused_global_attention_kv_len"]["launches_dinov2_vitl14"] = \
        dino["vitl14_full"]["forward"]["launches"]["fused_global_attention"]
    records["fused_ln_mlp_residual"]["launches_dinov2_vitg14"] = \
        dino["vitg14_full_fused_mlp"]["forward"]["launches"][
            "fused_ln_mlp_residual"]
    log("dinov2 extraction: " + json.dumps(dino))
    log(card_line())
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
