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
   K2's, K3's (its window mode's too) and the K6 forward's sources, K3's
   Hopper kernel and the Hopper kernels of the K5 forward and backward, K7
   (its C 768 body and its C 1536 cluster body), K8 and K6's bf16
   forward, dq and dkv (30 instances each), and K7's C 1536 loop instance
   (registers, spills),
   which must show no spill (the Hopper kernels also no ``C75xx`` wgmma
   serialisation line), and the K6 bf16 forward's mma.sync kernel and
   K7's fp32 C 1536 loop instance no spill; K3's loops must be built for
   fp32 at D 32 and 128 only (the tiled body takes fp32 at 64) and bf16 at
   32, 64 and 128;
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
   heads: their Hopper bodies, the forward's and dq's visiting the even
   key tiles before the odd ones, the routes asked), and the same at SAM
   ViT-B/16 @2048's global shape (B=1, Kh = Kw = 128, 16384 tokens), each
   output held against its plain version two heads at a time;
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
    and the bound; then the same three in bf16 (fp32 bias, the route
    asked and the launch counter of the body it names read) at SAM
    ViT-B/16's global shapes under ``fast`` at 768 px (2 x 12 x 2304, Kh =
    Kw = 48), 640 px (2 x 12 x 1600, Kh = Kw = 40), 896 px (2 x 12 x
    3136, Kh = Kw = 56) and 576 px (2 x 12 x 1296, Kh = Kw = 36: a width of
    4 mod 8) and DINOv2's kv_len shape, where all three take their Hopper
    bodies (TMA + wgmma), and at SAM @544's global shape (2 x 12 x 1156,
    Kh = Kw = 34) and SAM's 14 x 14 windows (50 x 12 x 196), where all
    three take the mma.sync bodies; the library bf16 SDPA (forward, or the
    whole backward) with a bf16 ``attn_mask`` at every shape;
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
    ``kv_grid`` (14, 14)), and the @768 global shape at the same width in
    heads of 32 and of 128 (24 x 32, 6 x 128), both dtypes; each against
    its plain version, with plain, SDPA and bound times, and the body its C
    entry takes (at D 64 the Hopper kernel in bf16, K1's whole-window body
    in bf16 window mode, the register-tiled forward in fp32, window mode
    too; the loops at D 32 and 128);
16. K7, the fused LayerNorm -> MLP -> residual, at the SAM forward's rows
    (16384 x 768, hidden 3072, bf16), DINOv2 ViT-B/14's (4 x 1370, with
    layerscale) and DINOv2 ViT-g/14's (4 x 1370 and 1 x 1370 rows of 1536,
    hidden 6144, with layerscale), against its plain version, its C entry
    asked which body it takes (the Hopper body, TMA and wgmma, at C 768;
    the cluster body, four blocks a 128-row tile with y multicast by TMA,
    at C 1536); the library time is the unfused PyTorch path (LayerNorm,
    two cuBLAS GEMMs, GELU, residual); then K7 in fp32 at C 1536
    (ViT-g/14's 4 x 1370 rows, hidden 6144, layerscale; the loops' 16-row,
    8-unit instance, on no path) against its plain version, the library
    the unfused path in fp32 with TF32 off;
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
    ``VDR_FUSED_MLP=1`` (a B=4 forward with 40 K7 and 40 K2 launches and
    the same forward unfused, device ms and idle share of each; at batch 1
    the fused forward held against the unfused one, and both held to a
    ``parity`` (fp32) forward on the same weights: the fused forward's
    error no larger than ``VITG_PARITY_RATIO`` times the unfused one's; one
    extraction); and ViT-L/14 ``full`` under ``int8`` at batch 1 (K8 in
    every block's five projections, K2 in each layer, launches asserted)
    against a ``parity`` plain-attention forward on the same weights, by
    JAX's criterion (the smallest per-position cosine above
    ``INT8_MIN_COSINE``);
20. SAM ViT-B/16 ``fast`` fine-tuning at 2048 px: ``FineTuner`` at full
    width and depth, batch 1, 5 steps (the main path of the K5 kernels at
    a key grid 128 keys wide: 8 windowed layers of 100 windows, 4 global
    layers of 16384 tokens; the launches of every step, the K5 routes, ms
    per step, peak memory, the loss of every step, parameters moved).
21. classifier training on the descriptors at the published transformer
    config (feature_dim 256, CT and PET encoders of 2 layers x 4 heads,
    FFN 1024, lr 5e-4, virtual batch 32) under ``TrainerConfig``'s
    defaults (bimodal, cross-modal focal loss, batch 8, ``fast``): 64
    train and 16 test ``TokenItem``s from a seed (CT 700-2048 tokens, PET
    60-400, token buckets up to 2048) through ``FoldTrainer`` and
    ``FoldBookkeeping`` (a train and a test epoch: 8 micro-batches, 2
    updates; the report JSONs, ``losses.html`` and a checkpoint, reloaded
    into a fresh model that must give the same test logits), a second
    train epoch timed (ms per micro-batch, samples/s, peak memory), a
    micro-batch step traced (device ms, idle share), one epoch each of the
    unimodal ``ct`` transformer (focal) and of the conv classifier on 7-14
    x 16 x 16 x 256 volumes, and one ``parity`` micro-batch step on the
    card against the CPU's at the same weights and batch (the loss and
    every gradient leaf within 1e-4 of the leaf's max |grad|). It launches
    none of K1-K8.
22. serving through ``cli.serve`` and ``engine.serve``: first K1 (325
    and 50 windows), K2 (batch 13 and 2) and K7 (batch 1, 4096 rows), the
    shapes serving gives them, in bf16 against their plain versions by
    the rules of phases 3 and 16; then (a) SAM ViT-B/16
    @1024 `fast` exported at B=4 by the CLI's ``export`` from the seed-0
    weights, ``serve run`` over 8 batches of random images (warm status
    and stats, img/s, latency p50/p90), the output equal bit for bit to a
    ``ViTDense`` on the same baked weights, 8 K1 and 4 K2 launches a call,
    one call from host images traced (device ms, idle share);
    (b) the bimodal raw-HU pipeline (CT int16 13 x 512², PET float32 2 x
    128², 512 tokens, B=1, `fast`) at the published classifier config with
    seeded weights, on ``make_server``'s handler behind
    ``ThreadingHTTPServer`` on 127.0.0.1: ``/health``, a malformed body
    (400), an unknown path (404), 8 requests, each response's four outputs
    held to the two-stage path (the backbone on the same baked weights,
    the trainer's tokens on the host, the classifier) within
    ``SERVE_ATOL``, 16 K1 and 8 K2 launches a request, the wall p50/p90,
    one request traced (device ms, idle share), the peak memory, and
    ``serve run --overlap`` over three requests (pinned copies on a side
    stream) equal to their responses; (c) an
    artifact exported with ``VDR_FUSED_MLP=1`` and served without it
    launches K7 in all 12 blocks.
23. whole-volume and fold-parallel classifier training at phase 21's
    published transformer config (bimodal, cross-modal focal loss,
    ``fast`` unless marked): (a) the 5 folds (the published k) in lockstep
    through ``ParallelFoldTrainer`` at B=8, each with 16 test items and
    64/60/56/64/48 train items (so the folds run out and fire their
    optimizer at different steps), CT 700-2048 and PET 60-400 tokens; a
    warm epoch, a timed train epoch and a test epoch (ms per lockstep
    step and the host's stacking, cast and copy of its batches, peak
    memory) against the same folds trained one by one by ``FoldTrainer``
    in the same run (their wall and peak); fold 2's ``fold_state`` through the
    port's checkpoint into a fresh ``FoldTrainer``, whose test scores must
    be the lockstep's within 2^-7 times the largest |logit| (derived at
    ``FOLD_CKPT_STEPS``); one lockstep step traced (device ms, idle
    share); (b) 2 folds under ``parity`` with dropout on, at the
    sequential batches' shapes, against two sequential ``FoldTrainer``s:
    losses within rel 2e-4, scores and parameters within rtol 2e-4 / atol
    2e-5 (JAX's own limits, JAX ``tests/test_foldpar.py:113-136``), the
    zero-gradient key third of each ``in_proj_bias`` within Adam's step
    bound; (c) whole volumes: 16 train and 8 test items of CT 1500-8192
    and PET 200-1600 tokens at B=4, buckets widened past 4096 to 8192 with
    no truncation (mask sums equal the item lengths, no warning), a train
    and a test epoch (ms per micro-batch, peak memory), an 8192-bucket
    micro-batch traced, and a ``parity`` B=1 step on the longest item on
    the card against the CPU's within 1e-4 of each leaf's max |grad|
    (phase 21's rule). It launches none of K1-K8.
24. SAM ViT-B/16 ``fast`` fine-tuning at 768 px: ``FineTuner`` at full
    width and depth, batch 2, 5 steps (the main path of K6 in bf16: the 4
    global layers' 48 x 48 grid fits no fused kernel and takes K6's
    Hopper bodies, the 8 windowed layers K1 and K4 over 14 x 14 windows of
    the grid padded to 56; the launches of every step held, each K6 launch
    counted under the body its C entry reports: K1 8, K4 8, the Hopper
    forward, dq and dkv 4, the mma.sync bodies, K2 and the K5 kernels 0;
    ms per step, peak memory, the loss of every step, parameters moved),
    then 3 traced steps (wall, device ms, idle share, top device costs);
25. SAM ViT-B/16 ``fast`` fine-tuning at 640 px, batch 2, 5 steps: the
    4 global layers' 40 x 40 grid fits no fused kernel, so the K6 forward,
    dq and dkv run their Hopper bodies at Kw 40, the launches of every
    step held as in phase 24 (the Hopper bodies 4 each, the mma.sync ones
    0), then 3 traced steps (device ms, idle share);
26. the same at 896 px (a 56 x 56 grid: the Hopper bodies at Kw 56), 5
    steps and 3 traced ones (ms per step, device ms, idle share, peak
    memory);
27. the same at 576 px (a 36 x 36 grid: the Hopper bodies at Kw 36, a
    width of 4 mod 8), 5 steps and 3 traced ones;
28. the same at 544 px, 5 steps: the main path of the K6 bf16 mma.sync
    bodies (the 34 x 34 grid's Kw 34, not a multiple of 4, fits no Hopper
    body), the mma.sync forward, dq and dkv 4 a step and the Hopper ones
    0.

Every phase runs at full width and depth. The line before the last is the
kernels' JSON record, and the last line is ``{"ok": true, "device":
{...}}``. Random weights from a seed; no network.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
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
# Sources that carry the register-tiled fp32 forward (f32_tiled_forward.cuh)
# and its instances (*tiled_kernel*: with and without bias; K3 also its
# window mode's), which must show no spill
TILED_SOURCES = {"fused_window_attention": 2, "fused_global_attention": 2,
                 "flash_attention": 3, "flash_attention_fwd": 2}
# K3's loops (*flash_f32_kernel*, *flash_bf16_kernel*): fp32 at D 32 and
# 128 (the tiled body takes every fp32 call at D 64), bf16 at 32, 64, 128
K3_LOOP_INSTANCES = {"flash_f32_kernel": (32, 128),
                     "flash_bf16_kernel": (32, 64, 128)}
# K3's window mode on K1's whole-window body (*window_kernel*): one
# instance per N of keys an item loads
K3_WINDOW_INSTANCES = 4
# Sources with Hopper kernels (*hopper_kernel*, this many) that must show
# no spill and no wgmma serialisation (ptxas's C75xx lines): K1 (the
# whole-window body at N 64, 208 and 256 keys), the K5 forward
# (K2's body with the lse store: no bias, Kw 64, and Kw 128 visiting the
# even key tiles first), the K5 dq and dkv (no bias, Kw 64, Kw 128), K7
# (the C 768 body and the C 1536 cluster body), K8 and K6's bf16 forward,
# dq and dkv (no bias, and one instance per key-grid width 16, 20, ... 128)
HOPPER_SOURCES = {"fused_window_attention": 3,
                  "global_attention_fwd_lse": 3, "fused_ln_mlp_residual": 2,
                  "int8_matmul": 1, "global_attention_bwd_dq": 3,
                  "global_attention_bwd_dkv": 3, "flash_attention_fwd": 30,
                  "flash_attention_bwd_dq": 30, "flash_attention_bwd_dkv": 30}
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
# K6 in bf16 against its plain versions on the same bf16 inputs and fp32
# bias, phase 10: |got - ref| <= K6_BF16_STEPS[shape][output] · 2^-8 ·
# max |ref| + 2^-7·|ref| on the bf16 outputs (one bf16 step of the element
# after fp32 sums in another order), K6_BF16_STEPS · 2^-8 · max |ref| alone
# on the fp32 bias gradients, and K6_BF16_LSE_ATOL on the fp32 lse. A gap
# comes from single roundings to bf16 (P, dS) that flip where two fp32 sums
# differ in their last bits. The kernels sum their products on the tensor
# cores, the plain versions on the CUDA cores: the plain backward with its
# products on the tensor cores comes within 3.1e-5 bf16 steps (as above) of
# the kernels' outputs at every shape and seed read below, and the plain
# version has 0.64-0.97 times the kernels' share of elements more than one
# bf16 step from the fp64 oracle of the rounding points
# (``utils/kernel_probe.py gaps``, PERF.md). Each shape's limits are about
# 1.5 times the largest kernel-against-plain gap of 10 seeds there (the
# probe's ``gaps``, 12 heads, an H100 SXM), in bf16 steps of the output's
# largest |ref|, for out, dq, dbias_h, dbias_w, dk, dv: SAM @768 0.299,
# 0.213, 0.423, 0.421, 0.113, 0.150; DINOv2 kv_len 0.313, 0.161, -, -,
# 0.170, 0.127; @640 0.334, 0.128, 0.199, 0.199, 0.088, 0.114; @896 0.270,
# 0.176, 0.260, 0.254, 0.156, 0.154; @576 0.277, 0.347, 0.659, 0.660,
# 0.239, 0.148 (the mma.sync backward's, and the Hopper backward's again
# to these digits); 14 x 14 windows 0.189, 0.215, 0.405, 0.436, 0.235,
# 0.150; @544 (the mma.sync backward) 0.284, 0.160, 0.228, 0.281, 0.126,
# 0.198.
# They follow no law in the number of keys summed (196 to 3136; dq's
# largest gap is @576's, dk's the windows'). The fp32 lse: 1.9e-6.
K6_BF16_STEPS = {
    "sam768_global": {"out": 0.45, "dq": 0.32, "dbias_h": 0.64,
                      "dbias_w": 0.64, "dk": 0.17, "dv": 0.23},
    "dinov2": {"out": 0.47, "dq": 0.25, "dk": 0.26, "dv": 0.20},
    "sam640_global": {"out": 0.51, "dq": 0.20, "dbias_h": 0.30,
                      "dbias_w": 0.30, "dk": 0.14, "dv": 0.18},
    "sam896_global": {"out": 0.41, "dq": 0.27, "dbias_h": 0.39,
                      "dbias_w": 0.39, "dk": 0.24, "dv": 0.24},
    "sam576_global": {"out": 0.42, "dq": 0.53, "dbias_h": 0.99,
                      "dbias_w": 1.0, "dk": 0.36, "dv": 0.23},
    "sam544_global": {"out": 0.43, "dq": 0.25, "dbias_h": 0.35,
                      "dbias_w": 0.43, "dk": 0.19, "dv": 0.30},
    "window": {"out": 0.29, "dq": 0.33, "dbias_h": 0.61, "dbias_w": 0.66,
               "dk": 0.36, "dv": 0.23}}
K6_BF16_LSE_ATOL = 3e-6
# K6 in bf16 at its paths' shapes: SAM ViT-B/16 @768's global layers under
# `fast` (B=2, a 48 x 48 grid, Kh = Kw = 48), DINOv2 ViT-B/14 @518's kv_len
# shape, SAM @640's (a 40 x 40 grid), @896's (56 x 56) and @576's (36 x
# 36: a width of 4 mod 8) global layers, SAM @544's (34 x 34: the main
# path of the mma.sync bodies, whose Kw 34 no Hopper body takes), and
# SAM's 14 x 14 windows (50 windows, which no bf16 path gives K6: a second
# check of the mma.sync bodies); at each the forward takes the body of
# K6_BF16_FWD_BODY and the backward that of K6_BF16_BWD_BODY (one
# predicate: the same body; rows and counters `<kernel>_hopper` or
# `<kernel>_bf16`). A row's numbers are those of its main path's shape,
# K6_BF16_MAIN_SHAPE.
K6_BF16_SHAPES = {"sam768_global": (2, 2304, 48, 48, None),
                  "dinov2": (2, 1536, 0, 0, 1370),
                  "sam640_global": (2, 1600, 40, 40, None),
                  "sam896_global": (2, 3136, 56, 56, None),
                  "sam576_global": (2, 1296, 36, 36, None),
                  "sam544_global": (2, 1156, 34, 34, None),
                  "window": (50, 196, 14, 14, None)}
K6_BF16_BWD_BODY = {"sam768_global": "hopper", "dinov2": "hopper",
                    "sam640_global": "hopper", "sam896_global": "hopper",
                    "sam576_global": "hopper", "sam544_global": "mma",
                    "window": "mma"}
K6_BF16_FWD_BODY = K6_BF16_BWD_BODY
K6_BF16_MAIN_SHAPE = {"flash_attention_fwd_hopper": "sam768_global",
                      "flash_attention_fwd_bf16": "sam544_global",
                      "flash_attention_bwd_dq_hopper": "sam768_global",
                      "flash_attention_bwd_dkv_hopper": "sam768_global",
                      "flash_attention_bwd_dq_bf16": "sam544_global",
                      "flash_attention_bwd_dkv_bf16": "sam544_global"}
# Phase 24, SAM ViT-B/16 `fast` fine-tuning at 768 px, B=2: launches per
# step (8 windowed layers of 14 x 14 windows over the 48 x 48 grid padded
# to 56: K1 and K4; 4 global layers of 2304 tokens, which no fused kernel
# takes: K6 in bf16, the forward, dq and dkv counted under their Hopper
# bodies' names; every other counter 0, the fp32 K6 builds' and the
# mma.sync bodies' included)
SAM768 = 768
FAST768_STEP_LAUNCHES = {"fused_window_attention": 8,
                         "window_attention_bwd": 8,
                         "flash_attention_fwd_hopper": 4,
                         "flash_attention_bwd_dq_hopper": 4,
                         "flash_attention_bwd_dkv_hopper": 4}
# Phases 25 and 26, the same at 640 px (the 40 x 40 grid, windows over it
# padded to 42) and at 896 px (56 x 56, windows exact): the forward, dq and
# dkv on their Hopper bodies at Kw 40 and 56
SAM640, SAM896 = 640, 896
FAST640_STEP_LAUNCHES = FAST768_STEP_LAUNCHES
FAST896_STEP_LAUNCHES = FAST768_STEP_LAUNCHES
# Phase 27, the same at 576 px: the 36 x 36 grid, whose Kw 36 (4 mod 8)
# the Hopper bodies take with their doubled dkv terms and the forward's and
# dq's column-pair masks
SAM576 = 576
FAST576_STEP_LAUNCHES = FAST768_STEP_LAUNCHES
# Phase 28, the same at 544 px: the 34 x 34 grid (windows over it padded to
# 42), whose Kw 34 (not a multiple of 4) no Hopper body takes, so the
# forward, dq and dkv run and count under the mma.sync bodies
SAM544 = 544
FAST544_STEP_LAUNCHES = {"fused_window_attention": 8,
                         "window_attention_bwd": 8,
                         "flash_attention_fwd_bf16": 4,
                         "flash_attention_bwd_dq_bf16": 4,
                         "flash_attention_bwd_dkv_bf16": 4}
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
# heads of 64, bf16, the three on their Hopper bodies (``KW128_ROUTES``),
# each output against its plain version and the chain against the plain
# chain; limits about 1.5 times the gap measured on an H100 SXM with the
# mma.sync loops: out 4.87e-4,
# lse 2.40e-3, dq 5.88e-4, dbias_h 2.87e-3, dbias_w 2.08e-3, dkv 9.40e-4;
# chain dq 4.98e-4, dbias_h 8.54e-4, dbias_w 5.30e-4, dkv 6.98e-4. The
# same limits hold the three at SAM @2048's own global shape
# (``KW128_SAM2048``). dbias_h and dbias_w sit further
# from the plain version than at Kw 64 because the backward kernel is fed
# the kernel forward's lse, scored on Q^ = bf16(q D^-1/2 log2 e), where the
# plain version scores the fp32 q: fed Q^ instead, the plain version gives
# the kernel's bias gradients within one bf16 step (3.2e-8 beyond it;
# tests/test_torch_cuda_kernels.py); the chain,
# which scores alike on each side, stays within the Kw 64 limits
KW128 = (1, 32, 128)
KW128_SAM2048 = (1, 128, 128)
KW128_ROUTES = {"fwd": "hopper", "dq": "hopper", "dkv": "hopper"}
# SAM ViT-B/16 @2048, phase 20: the image size and the grid of 16 px patches
SAM2048 = (2048, 128)
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
# with layerscale) and at batch 1, whose last 128-row tile and last cluster
# are ragged: the cluster body; the C 768 shapes take the Hopper body
# K7 in fp32 at C 1536 (DINOv2 ViT-g/14's rows at batch 4, hidden 6144,
# with layerscale; on no path of the port, JAX's own test runs it) against
# its plain version in fp32 (TF32 off on both): |got - ref| <= this, about
# 1.5 times the gap measured on an H100 SXM (8.34e-7; PERF.md)
K7_F32_WIDE = (4, 1370, 1536, 6144)
K7_F32_ATOL = 1.3e-6
K7_SHAPES = {"sam": (4, 4096, 768, 3072, False, "hopper"),
             "dinov2": (4, 1370, 768, 3072, True, "hopper"),
             "dinov2_vitg14": (4, 1370, 1536, 6144, True, "cluster"),
             "dinov2_vitg14_b1": (1, 1370, 1536, 6144, True, "cluster")}
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
# otherwise and read 1.309e-1, the cluster body 1.001e-1)
DINO_PATHS = {
    "vitl14_full": ("dinov2_vitl14", "full", {},
                    dict(fused_global_attention=24)),
    "vitl14_patch_embed": ("dinov2_vitl14", "patch_embed", {}, {}),
    "vitg14_full_fused_mlp": ("dinov2_vitg14", "full", {"VDR_FUSED_MLP": "1"},
                              dict(fused_global_attention=40,
                                   fused_ln_mlp_residual=40)),
}
DINO_ATOL = {"vitl14_full": 0.12, "vitg14_full_fused_mlp": 0.15}
# ViT-g/14 at batch 1: the fused forward's max abs error against a `parity`
# (fp32) forward on the same weights may be at most this many times the
# unfused forward's, about 1.5 times the ratio measured on an H100 SXM
# with the cluster body (1.000: 1.558e-1 each, on max |x| 5.5)
VITG_PARITY_RATIO = 1.5
INT8_MIN_COSINE = 0.995             # JAX tests/test_quant.py:116
# Phase 21, classifier training: the published classifier configs
# (conf/parameters_models.yaml `models`, held equal to it by
# tests/test_torch_train.py; the card's machine has no yaml) and the token
# buckets up to `runtime.max_tokens` 2048
_LAYER = {"num_layers": 2, "num_heads": 4, "mlp_ratio": 4}
CLASSIFIER_CFG = {"models": {
    "transformer": {"learning_rate": 0.0005, "feature_dim": 256,
                    "batch_size": 1, "virtual_batch_size": 32,
                    "num_epochs": 50, "patience": 15,
                    "chest": _LAYER, "ct": _LAYER, "pet": _LAYER},
    "conv": {"learning_rate": 0.0005, "feature_dim": 256, "batch_size": 1,
             "virtual_batch_size": 32, "num_epochs": 50, "patience": 15,
             "ct": {"div": 2}, "pet": {"div": 2}}}}
MAX_TOKENS = 2048
# 64 train and 16 test items, balanced labels; CT 700-2048 tokens (buckets
# 1024, 2048), PET 60-400 (buckets 128-512); conv volumes of 7-14 slices of
# 16 x 16 x 256
CLS_ITEMS = {"train": 64, "test": 16, "ct": (700, MAX_TOKENS),
             "pet": (60, 400), "conv_slices": (7, 14), "conv_train": 16}
# The `parity` micro-batch step on the card against the CPU's at the same
# weights and batch: the loss and every gradient leaf within this share of
# the leaf's max |grad| (TF32 off on the card, the sum order alone)
CLS_PARITY_REL = 1e-4
# Phase 22, serving: the dense SAM ViT-B/16 @1024 `fast` artifact at B=4
# over 8 batches, and the bimodal raw-HU pipeline at the published
# classifier config (CT int16 13 x 512², PET float32 2 x 128², a 512-token
# budget, B=1) served over HTTP; each request's launches (two backbone
# calls: the 13 CT and the 2 PET slices), each forward's
SERVE_BATCH, SERVE_BATCHES, SERVE_REQUESTS = 4, 8, 8
SERVE_SLICES = {"ct": 13, "pet": 2}
SERVE_NATIVE = {"ct": 512, "pet": 128}
SERVE_MAX_TOKENS = 512
SERVE_LAUNCHES = {
    "dense": dict(fused_window_attention=8, fused_global_attention=4),
    "pipeline": dict(fused_window_attention=16, fused_global_attention=8),
    "fused_mlp": dict(fused_ln_mlp_residual=12, fused_window_attention=8,
                      fused_global_attention=4),
}
# nodule discs on the 64 x 64 descriptor grid, in cells: CT 37 cells x 13
# slices (481 voxels), PET 81 x 2 (162), both within the token budget
SERVE_RADII = {"ct": 3.2, "pet": 5.0}
# a response's four outputs against the two-stage path (the backbone, the
# trainer's tokens on the host, the classifier), elementwise: about 1.5
# times the gap measured on an H100 SXM (7.81e-3, one bf16 step of an
# output between 1 and 2; 3.91e-3 on 7 of 8 requests): the encoding's
# sin/cos on the card against the host's moves a bf16 rounding in the
# classifier
SERVE_ATOL = 1.2e-2
# The kernels at the shapes serving gives them that no earlier phase runs,
# each held against its plain version by the limits of phases 3 and 16
# (bf16): K1 over a CT stack's 13 x 25 and a PET stack's 2 x 25 windows,
# K2 at batch 13 and 2, K7 at batch 1 (4096 rows, the routing cell)
SERVE_KERNEL_SHAPES = {
    "fused_window_attention": {"ct": 325, "pet": 50},
    "fused_global_attention": {"ct": 13, "pet": 2},
    "fused_ln_mlp_residual": {"b1": 1},
}


# Phase 23, whole-volume and fold-parallel training at the published
# transformer config (`fast`, bimodal, cross-modal focal loss). Lockstep:
# the published k of 5 folds at B=8, each fold 16 test items and its own
# number of train items, so the folds run out and fire their optimizer at
# different steps (8, 8, 7, 8 and 6 micro-batches); CT and PET lengths as
# phase 21's (CLS_ITEMS)
FOLD_TRAIN_ITEMS = (64, 60, 56, 64, 48)
FOLD_TEST_ITEMS = 16
# `parity` equality with dropout on: 2 folds of 16 and 8 train items (one
# update each) and 8 test items, every item CT 1024 / PET 256 tokens, so
# every lockstep step has the sequential batches' shapes; losses within
# rel 2e-4, scores and parameters within rtol 2e-4 / atol 2e-5 (JAX's own
# limits, tests/test_foldpar.py:113-136). The key third of each
# in_proj_bias has a zero gradient in exact arithmetic (a bias on every
# key of a row cancels in the softmax); Adam's first update turns either
# side's rounding noise there into a step of up to lr, so that slice is
# held to 2 lr per update instead (tests/test_torch_train.py's rule)
FOLD_EQ = {"train": (16, 8), "test": 8, "ct": 1024, "pet": 256}
FOLD_SEQ_REL, FOLD_SEQ_RTOL, FOLD_SEQ_ATOL = 2e-4, 2e-4, 2e-5
FOLD_KEY_BIAS_STEPS = 2.0
# The `fast` checkpoint round trip: fold_state(f) through the port's
# checkpoint into a fresh FoldTrainer, whose test scores are held to the
# lockstep's. Both compute the same function of the same weights and
# tokens; they differ only in the key padding (exact zeros after the
# softmax) and in how the GEMMs batch (one product per fold against one
# per stack: another fp32 summation order). A different order can move a
# bf16-rounded activation by one bf16 step (2^-8 relative); allowing 4
# such steps on each of the two logits of a score, a score (the sigmoid
# of their difference, slope <= 1/4) moves by at most 2 x 4 x 2^-8 x M / 4
# = 2^-7 x M, M the largest |logit|, at least 1
FOLD_CKPT_STEPS = 4
# Whole volume: 16 train and 8 test items at B=4, CT 1500-8192 tokens
# (buckets 2048, 4096 and 8192, past DEFAULT_BUCKETS' 4096 cap) and PET
# 200-1600. attention_reference keeps fp32 (B, 4, S, S) scores: 4.3 GB each
# at B=4 and S=8192, and the backward keeps about two a CT layer, so B=8
# would come near the card's 80 GB
WV_ITEMS = {"train": 16, "test": 8, "ct": (1500, 8192), "pet": (200, 1600),
            "batch": 4}


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
    |got - ref| <= atol + rtol·|ref| (``rtol`` and ``atol`` one for all
    outputs or one each); returns the largest |got - ref|."""
    atols = atol if isinstance(atol, (list, tuple)) else [atol] * len(outs)
    rtols = rtol if isinstance(rtol, (list, tuple)) else [rtol] * len(outs)
    worst = 0.0
    for got, ref, label, lim, rtol in zip(outs, refs, labels, atols, rtols):
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


# the K5 records' short names in KW128_ROUTES
K5_SHORT = {"global_attention_fwd_lse": "fwd", "global_attention_bwd_dq": "dq",
            "global_attention_bwd_dkv": "dkv"}


def _k5_kw128_routes(G, q, kv, bh, bw, heads, tag):
    """Ask the three K5 C entries which body they run on a key grid 128
    keys wide; they must answer ``KW128_ROUTES``."""
    routes = {"fwd": G.global_attention_fwd_route(q, kv, bh, bw,
                                                  num_heads=heads)}
    for kernel in ("dq", "dkv"):
        routes[kernel] = G.global_attention_bwd_route(
            q, kv, bh, bw, num_heads=heads, kernel=kernel)
    log(f"kernel K5 {tag}: routes {routes}")
    if routes != KW128_ROUTES:
        raise AssertionError(f"K5 {tag} routes {routes}, not "
                             f"{KW128_ROUTES}")
    return routes


def k5_kw128(torch, G, peaks, records, rand):
    """Phase 7, Kw 128: the three K5 kernels on a key grid 128 keys wide
    (``KW128``), each C entry asked for its body (``KW128_ROUTES``), each
    output against its plain version, the kernel chain against the plain
    chain; then the same kernels at SAM @2048's global shape
    (:func:`k5_sam2048`). Times, SDPA and bounds go under each K5 record's
    ``by_shape``."""
    b, kh, kwidth = KW128
    heads, d = 12, 64
    c, scale, s = heads * d, d ** -0.5, kh * kwidth
    q, kv, dout = rand(b, s, c), rand(b, s, 2 * c), rand(b, s, c)
    bh = rand(b, heads, s, kh, s=0.3)
    bw = rand(b, heads, s, kwidth, s=0.3)
    kw = dict(num_heads=heads, scale=scale)
    tag = f"[Kw 128, B={b}, Kh {kh}]"
    routes = _k5_kw128_routes(G, q, kv, bh, bw, heads, tag)
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
            _sub(rec), body=routes[K5_SHORT[name]])
    del q, kv, dout, bh, bw, out, lse, args, got, dkv
    torch.cuda.empty_cache()
    k5_sam2048(torch, G, peaks, records, rand)


def _head_slice(torch, args, h0, h1, d=64):
    """The K5 operands ``args`` (q, kv, bias_h, bias_w, kv_len[, dout, lse,
    delta]) cut to heads [h0, h1)."""
    c = args[0].shape[-1]
    cols = slice(h0 * d, h1 * d)
    kv = torch.cat([args[1][..., cols], args[1][..., c + h0 * d:c + h1 * d]],
                   -1)
    cut = [args[0][..., cols], kv, args[2][:, h0:h1], args[3][:, h0:h1],
           args[4]]
    if len(args) > 5:
        cut += [args[5][..., cols], args[6][:, h0:h1], args[7][:, h0:h1]]
    return tuple(None if x is None else x.contiguous() for x in cut)


def _plain_by_heads(torch, plain, args, heads, step, scale, dims):
    """``plain`` (a K5 plain version) on ``args`` ``step`` heads at a time,
    its outputs joined back to the whole call's layout: output i along
    ``dims[i]`` (-1 the head columns, 1 the heads of (B, H, ...)); ``dims``
    None for dkv, whose k and v columns join apart."""
    parts = [plain(*_head_slice(torch, args, h0, h0 + step),
                   num_heads=step, scale=scale)
             for h0 in range(0, heads, step)]
    if dims is None:                         # dkv: (B, S, 2·step·D) each
        half = parts[0].shape[-1] // 2
        return (torch.cat([x[..., :half] for x in parts]
                          + [x[..., half:] for x in parts], -1),)
    return tuple(torch.cat([x[i] for x in parts], dim)
                 for i, dim in enumerate(dims))


def k5_sam2048(torch, G, peaks, records, rand):
    """Phase 7 at SAM ViT-B/16 @2048's global shape (``KW128_SAM2048``:
    B=1, Kh = Kw = 128, 16384 tokens, 12 heads of 64): the routes, the
    kernel forward's out and lse fed to the dq and dkv kernels, each output
    held against its plain version under ``KW128_ATOL``, two heads at a
    time (one plain call over all 12 heads would hold several (S, S) fp32
    score tensors of 12.9 GB), the plain version's peak memory printed;
    times, SDPA (its dense bias fits: 6.4 GB in bf16) and bounds under
    each K5 record's ``by_shape["sam2048"]``."""
    b, kh, kwidth = KW128_SAM2048
    heads, d, step = 12, 64, 2
    c, scale, s = heads * d, d ** -0.5, kh * kwidth
    q, kv, dout = rand(b, s, c), rand(b, s, 2 * c), rand(b, s, c)
    bh = rand(b, heads, s, kh, s=0.3)
    bw = rand(b, heads, s, kwidth, s=0.3)
    kw = dict(num_heads=heads, scale=scale)
    tag = f"[SAM @2048 global, B={b}, Kh {kh}, Kw {kwidth}]"
    routes = _k5_kw128_routes(G, q, kv, bh, bw, heads, tag)
    fwd_args = (q, kv, bh, bw, None)
    out, lse = G.global_attention_fwd_lse(*fwd_args, **kw)
    args = (*fwd_args, dout, lse, G.attention_delta(out, dout, heads))
    got = G.global_attention_bwd_dq(*args, **kw)
    dkv = G.global_attention_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    plains = {"global_attention_fwd_lse": (G.global_attention_fwd_lse_plain,
                                           fwd_args, (-1, 1)),
              "global_attention_bwd_dq": (G.global_attention_bwd_dq_plain,
                                          args, (-1, 1, 1)),
              "global_attention_bwd_dkv": (G.global_attention_bwd_dkv_plain,
                                           args, None)}
    held = {"global_attention_fwd_lse": ((out, lse), ("out", "lse"),
                                         (2.0 ** -7, 0.0)),
            "global_attention_bwd_dq": (got, ("dq", "dbias_h", "dbias_w"),
                                        (2.0 ** -7,) * 3),
            "global_attention_bwd_dkv": ((dkv,), ("dkv",), (2.0 ** -7,))}
    errs = {}
    for name, (plain, p_args, dims) in plains.items():
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref = _plain_by_heads(torch, plain, p_args, heads, step, scale, dims)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"plain {name} {tag}: {heads // step} calls of {step} heads, "
            f"peak memory {peak / 2 ** 30:.2f} GiB beyond the operands")
        outs, labels, rtols = held[name]
        errs[name] = max(
            _check_outputs(torch, f"{name} {tag}", [o], [r], [lab], rt,
                           KW128_ATOL["lse" if lab == "lse" else name])
            for o, r, lab, rt in zip(outs, ref, labels, rtols))
        del ref
    qh, kh_, vh, doh = (_heads_of(t, 1, s, heads)
                        for t in (q, kv[..., :c], kv[..., c:], dout))
    mask = _dense_mask(bh, bw, 1, s, heads)
    fwd_lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale)
    bwd_lib = _sdpa_ms(torch, qh, kh_, vh, mask, scale, doh)
    del qh, kh_, vh, doh, mask
    torch.cuda.empty_cache()
    fl = 4.0 * b * heads * s * s * d
    rows = {
        "global_attention_fwd_lse": (
            lambda: G.global_attention_fwd_lse(*fwd_args, **kw), fwd_lib,
            _nbytes(q, kv, bh, bw, out, lse), fl),
        "global_attention_bwd_dq": (
            lambda: G.global_attention_bwd_dq(*args, **kw), bwd_lib,
            _nbytes(*args[:4], *args[5:], *got), 1.5 * fl),
        "global_attention_bwd_dkv": (
            lambda: G.global_attention_bwd_dkv(*args, **kw), bwd_lib,
            _nbytes(*args[:4], *args[5:], dkv), 2.0 * fl)}
    for name, (fn, lib, nb, flops) in rows.items():
        plain_ms = cuda_ms(torch, lambda: _plain_by_heads(
            torch, *plains[name][:2], heads, step, scale, plains[name][2]),
            1)
        rec = _record(f"{name} {tag}", f"{name}.cu", "", "bfloat16",
                      errs[name], cuda_ms(torch, fn, 3), plain_ms, lib, nb,
                      flops, peaks)
        records[name].setdefault("by_shape", {})["sam2048"] = dict(
            _sub(rec), body=routes[K5_SHORT[name]])
    del q, kv, dout, bh, bw, out, lse, args, fwd_args, got, dkv
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
                   per_step=STEP_LAUNCHES, batch_size=2, backbone_cfg=None,
                   trace=False):
    """A fine-tuning main path: ``FineTuner`` at full width and depth,
    ``batch_size`` 2 unless given, 5 steps on a fixed batch, the launches
    of every step held to ``per_step``. SAM ViT-B/16 @1024 ``fast`` runs
    K1/K4/K5, ``parity`` K6; DINOv2 ViT-B/14 @518 ``fast`` runs K5 in
    kv_len mode, ``parity`` K6 in kv_len mode; ``backbone_cfg`` replaces
    the backbone's config (SAM @2048: K5 at a key grid 128 keys wide; SAM
    @768: K1/K4 and K6 in bf16). Returns the launches; with ``trace`` also
    the steps' summary (ms per step, peak memory, and the wall ms, device
    ms and idle share of traced steps after the counted ones,
    ``utils/profiling.py::trace_runs``)."""
    tuner = ft.FineTuner(ft.FineTuneConfig(backbone=backbone,
                                           precision=precision,
                                           backbone_cfg=backbone_cfg))
    state = tuner.init(seed=SEED)
    cfg = tuner.backbone_cfg
    batch = _ft_batch(torch, batch_size, cfg.image_size, cfg.grid)
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
    log(f"fine-tune {cfg.name} @{cfg.image_size} {precision} B={batch_size}"
        f", {FT_STEPS} steps: ms per step "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)}; steady (steps "
        f"3-{FT_STEPS}) {steady * 1e3:.2f} ms = {batch_size / steady:.2f} "
        f"img/s; "
        f"peak memory {peak / 2 ** 30:.3f} GiB; losses "
        f"{', '.join(f'{x:.6g}' for x in losses)}; max parameter move "
        f"{moved:.3e}; launches {counts}")
    expect = {k: FT_STEPS * per_step.get(k, 0) for k in A.LAUNCHES}
    if counts != expect:
        raise AssertionError(f"fine-tune launches {counts} != {expect}")
    if not all(np.isfinite(losses)) or not moved > 0 or \
            tuple(logits.shape) != (batch_size, 2):
        raise AssertionError("fine-tuning: non-finite loss or no update")
    if not trace:
        return counts
    from vit_deep_radiomics_tpu_torch.utils import profiling

    prof = profiling.trace_runs(lambda: tuner.step(state, *batch), 3, 8)
    log(f"fine-tune {cfg.name} @{cfg.image_size} {precision} B={batch_size}"
        f" traced: wall {prof['wall_ms']:.3f} ms, device "
        f"{prof['device_ms']:.3f} ms, idle share {prof['idle_share']:.3f}; "
        + "; ".join(f"{x['name'][:40]} {x['calls']:g}x {x['ms']:.3f} ms"
                    for x in prof["top"]))
    return counts, {"step_ms": [t * 1e3 for t in times],
                    "steady_ms": steady * 1e3,
                    "peak_memory_gib": peak / 2 ** 30,
                    "losses": losses,
                    **{k: prof[k] for k in ("wall_ms", "device_ms",
                                            "idle_share")}}


def sam2048_phase(torch, A, G, ft, vit):
    """Phase 20: SAM ViT-B/16 ``fast`` fine-tuning at 2048 px, batch 1, the
    main path of the K5 backward at a key grid 128 keys wide: the three K5
    C entries asked for their bodies at its global layers' shape (1, 16384
    tokens, Kh = Kw = 128; ``KW128_ROUTES``), then ``FT_STEPS`` steps whose
    launches are held to ``STEP_LAUNCHES`` (8 windowed layers: K1 and K4;
    4 global layers: the three K5 kernels)."""
    size, grid = SAM2048
    heads, c, s = 12, 768, grid * grid

    def zeros(*shape):
        return torch.zeros(*shape, device="cuda", dtype=torch.bfloat16)

    _k5_kw128_routes(G, zeros(1, s, c), zeros(1, s, 2 * c),
                     zeros(1, heads, s, grid), zeros(1, heads, s, grid),
                     heads, "[SAM @2048 fast step]")
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=size)
    return finetune_phase(torch, A, ft, batch_size=1, backbone_cfg=cfg)


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


def k6_inputs(torch, gen, dt, b, s, kh, kw, kv_len, heads=12, d=64):
    """K6's operands at one shape of ``K6_SHAPES`` or ``K6_BF16_SHAPES``:
    ((q, k, v, bias_h, bias_w, kv_len), dO), q, k, v and dO (B, H, S, D)
    normal in ``dt``, the bias factors fp32 (normal times 0.3) when Kh is
    given, else kv_len (int32, one per batch row) when given."""
    def rand(*sh, sc=1.0):
        return torch.randn(*sh, generator=gen, device="cuda") * sc

    q, k, v, dout = (rand(b, heads, s, d).to(dt) for _ in range(4))
    bh = bw = kl = None
    if kh:
        bh, bw = rand(b, heads, s, kh, sc=0.3), rand(b, heads, s, kw, sc=0.3)
    if kv_len:
        kl = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
    return (q, k, v, bh, bw, kl), dout


def k6_phase(torch, G, peaks, dtype="float32"):
    """Phase 10: the three K6 kernels at their paths' shapes, each output
    against its plain version (the backward kernels fed the forward
    kernel's lse), the body the C entries take asked; kernel, plain-version
    and library (SDPA with the dense bias, or the padding mask, as
    ``attn_mask`` in the operands' dtype; forward, or the whole backward)
    times and the bound. fp32: the ``parity`` path's shapes
    (``K6_SHAPES``, the register-tiled bodies); bf16: ``K6_BF16_SHAPES``
    (SAM @768's, @640's, @896's, @576's and @544's global layers under
    ``fast``,
    DINOv2's kv_len shape and SAM's 14 x 14 windows, the fp32 bias; the
    forward's body of ``K6_BF16_FWD_BODY``, the backward's of
    ``K6_BF16_BWD_BODY``, rows ``<kernel>_hopper`` or ``<kernel>_bf16``).
    Each launch is held to have counted under its row's name. A row's
    numbers are its main path's shape's (fp32: SAM's global shape; bf16:
    ``K6_BF16_MAIN_SHAPE``); ``by_shape`` holds every shape."""
    bf16 = dtype == "bfloat16"
    shapes = K6_BF16_SHAPES if bf16 else K6_SHAPES
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + (10 if bf16 else 4))
    dt = getattr(torch, dtype)
    heads, d = 12, 64
    scale = d ** -0.5
    grad = "vit_deep_radiomics_tpu/ops/attention_grad.py"
    where = {"flash_attention_fwd": f"{grad}:56",
             "flash_attention_bwd_dq": f"{grad}:186",
             "flash_attention_bwd_dkv": f"{grad}:266"}

    def limits(shape, name, labels, refs):
        """(rtols, atols) of the outputs ``labels`` of kernel ``name`` at
        ``shape`` against their plain versions ``refs``: fp32 ``K6_ATOL``;
        bf16 the shape's ``K6_BF16_STEPS`` bf16 steps of each output's
        largest |ref| (the lse ``K6_BF16_LSE_ATOL``), with one bf16 step of
        the element (``RTOL``) on the bf16 outputs (not on the fp32 lse and
        bias gradients)."""
        if not bf16:
            return 0.0, [K6_ATOL["lse" if lb == "lse" else name]
                         for lb in labels]
        return ([0.0 if lb in ("lse", "dbias_h", "dbias_w") else RTOL[dtype]
                 for lb in labels],
                [K6_BF16_LSE_ATOL if lb == "lse" else
                 K6_BF16_STEPS[shape][lb] * 2.0 ** -8
                 * r.float().abs().max().item()
                 for lb, r in zip(labels, refs)])

    def body_of(name, shape, args):
        """(body, row name) of kernel ``name`` at ``shape``: the body its
        C entry's route names, held to the one expected."""
        if name == "flash_attention_fwd":
            got = G.flash_attention_route(*args)
            want = K6_BF16_FWD_BODY[shape] if bf16 else "tiled"
        else:
            got = G.flash_attention_bwd_route(*args,
                                              kernel=name.split("_")[-1])
            want = K6_BF16_BWD_BODY[shape] if bf16 else "tiled"
        log(f"kernel {name} [{dtype} {shape}]: route {got}")
        if got != want:
            raise AssertionError(f"{name} [{dtype} {shape}] takes the {got} "
                                 f"body, not the {want} one")
        return got, name + ("_hopper" if got == "hopper" else
                            "_bf16" if bf16 else "")

    def launch(name, shape, fn):
        """(body, row name, outputs): kernel ``name`` launched once by
        ``fn``, held to have counted one launch under the row name of the
        body its route names and none under any other."""
        body, row_name = body_of(name, shape, args)
        before = dict(G.LAUNCHES)
        outs = fn()
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in G.LAUNCHES.items()
                 if n != before[k]}
        if moved != {row_name: 1}:
            raise AssertionError(f"{name} [{dtype} {shape}] counted "
                                 f"{moved}, not one {row_name} launch")
        return body, row_name, outs

    rows = {}
    for shape, (b, s, kh, kw, kv_len) in shapes.items():
        (q, k, v, bh, bw, kl), dout = k6_inputs(torch, gen, dt, b, s, kh,
                                                kw, kv_len)
        n_keys = kv_len or s
        if kv_len:
            key = torch.arange(s, device="cuda")
            mask = torch.zeros(b, heads, s, s, device="cuda",
                               dtype=dt).masked_fill(key >= n_keys,
                                                     float("-inf"))
        else:
            mask = (bh[..., :, None] + bw[..., None, :]).reshape(
                b, heads, s, s).to(dt)
        args, pairs = (q, k, v, bh, bw, kl), b * heads * s * n_keys * d
        iters = 20 if s < 1000 else 5
        tag = f"[{dtype} {shape}]"

        def row(name, body, row_name, err, fn, plain, lib, nb, flops):
            ms = cuda_ms(torch, fn, iters)
            plain_ms = cuda_ms(torch, plain, 2)
            src = "flash_trainable_hopper.cuh" if body == "hopper" else \
                f"{name}.cu"
            rows.setdefault(row_name, {})[shape] = dict(_record(
                f"{row_name} {tag}", src, where[name], dtype, err, ms,
                plain_ms, lib, nb, flops, peaks), body=body)

        body, row_name, (out, lse) = launch(
            "flash_attention_fwd", shape,
            lambda: G.flash_attention_fwd(*args, scale=scale))
        ref = G.flash_attention_fwd_plain(*args, scale=scale)
        err = _check_outputs(
            torch, f"flash_attention_fwd {tag}", [out, lse], ref,
            ["out", "lse"],
            *limits(shape, "flash_attention_fwd", ["out", "lse"], ref))
        row("flash_attention_fwd", body, row_name, err,
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
            body, row_name, got = launch(
                name, shape, lambda: fn(*args, *rest, scale=scale))
            ref = plain_fn(*args, *rest, scale=scale)
            keep = [i for i, r in enumerate(ref) if r is not None]
            err = _check_outputs(
                torch, f"{name} {tag}", [got[i] for i in keep],
                [ref[i] for i in keep], [labels[i] for i in keep],
                *limits(shape, name, [labels[i] for i in keep],
                        [ref[i] for i in keep]))
            del ref
            row(name, body, row_name, err,
                lambda: fn(*args, *rest, scale=scale),
                lambda: plain_fn(*args, *rest, scale=scale), lib,
                _nbytes(*args, *rest, *got), flops)
            del got
        del q, k, v, dout, bh, bw, kl, mask, args, out, lse, rest
        torch.cuda.empty_cache()
    log(f"library yardstick of both K6 {dtype} backward kernels: the whole "
        f"{dtype} SDPA backward (dq, dk, dv and, with a bias, the mask "
        "gradient)")
    records = {}
    for row_name, by in rows.items():
        main = K6_BF16_MAIN_SHAPE[row_name] if bf16 else "sam_global"
        rec = dict(by[main], name=row_name)
        rec["by_shape"] = {shape: dict(_sub(r), body=r["body"])
                           for shape, r in by.items()}
        records[row_name] = rec
    return records


def sam768_phase(torch, A, ft, vit):
    """Phase 24: SAM ViT-B/16 ``fast`` fine-tuning at 768 px, batch 2, the
    main path of K6 in bf16: its global layers' 48 x 48 grid fits no fused
    kernel, so they take the generic path. ``FT_STEPS`` steps whose
    launches are held to ``FAST768_STEP_LAUNCHES`` (K1 and K4 in the 8
    windowed layers; in the 4 global ones the K6 forward, dq and dkv under
    the Hopper bodies' counters, each counted by the body its C entry
    reports it launched; K2, the K5 kernels and the mma.sync bodies 0),
    then traced steps (device ms, idle share).
    Returns (launches, the steps' summary)."""
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=SAM768)
    return finetune_phase(torch, A, ft, per_step=FAST768_STEP_LAUNCHES,
                          backbone_cfg=cfg, trace=True)


def sam640_phase(torch, A, ft, vit):
    """Phase 25: SAM ViT-B/16 ``fast`` fine-tuning at 640 px, batch 2: its
    global layers' 40 x 40 grid fits no fused kernel, so they take K6 in
    bf16, the forward, dq and dkv on their Hopper bodies at Kw 40 (48-key
    tiles).
    ``FT_STEPS`` steps whose launches are held to ``FAST640_STEP_LAUNCHES``,
    then traced steps. Returns (launches, the steps' summary)."""
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=SAM640)
    return finetune_phase(torch, A, ft, per_step=FAST640_STEP_LAUNCHES,
                          backbone_cfg=cfg, trace=True)


def sam896_phase(torch, A, ft, vit):
    """Phase 26: SAM ViT-B/16 ``fast`` fine-tuning at 896 px, batch 2: the
    8 windowed layers run K1 and K4 over 14 x 14 windows of the 56 x 56
    grid, the 4 global layers (3136 tokens, which no fused kernel takes)
    the K6 bf16 forward, dq and dkv on their Hopper bodies at Kw 56
    (64-key tiles).
    ``FT_STEPS`` steps whose launches are held to
    ``FAST896_STEP_LAUNCHES``, then traced steps. Returns (launches, the
    steps' summary)."""
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=SAM896)
    return finetune_phase(torch, A, ft, per_step=FAST896_STEP_LAUNCHES,
                          backbone_cfg=cfg, trace=True)


def sam576_phase(torch, A, ft, vit):
    """Phase 27: SAM ViT-B/16 ``fast`` fine-tuning at 576 px, batch 2: its
    global layers' 36 x 36 grid (1296 tokens) fits no fused kernel, so they
    take K6 in bf16, the forward, dq and dkv on their Hopper bodies at Kw
    36, a width of 4 mod 8 (48-key forward and dq tiles with 36 live
    columns, dkv's terms staged twice). ``FT_STEPS`` steps whose launches
    are held to ``FAST576_STEP_LAUNCHES``, then traced steps. Returns
    (launches, the steps' summary)."""
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=SAM576)
    return finetune_phase(torch, A, ft, per_step=FAST576_STEP_LAUNCHES,
                          backbone_cfg=cfg, trace=True)


def sam544_phase(torch, A, ft, vit):
    """Phase 28: SAM ViT-B/16 ``fast`` fine-tuning at 544 px, batch 2, the
    main path of the K6 bf16 mma.sync bodies: its global layers'
    34 x 34 grid fits no fused kernel and no Hopper body (Kw 34 is not a
    multiple of 4). ``FT_STEPS`` steps whose launches are held to
    ``FAST544_STEP_LAUNCHES``. Returns the launches."""
    cfg = dataclasses.replace(vit.SAM_VIT_B, image_size=SAM544)
    return finetune_phase(torch, A, ft, per_step=FAST544_STEP_LAUNCHES,
                          backbone_cfg=cfg)


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
    ``attn_mask``) times and the bound. The bound's operations count only
    the valid keys and the query rows the path keeps; its bytes q and the
    output whole (every query row is computed and stored, a window's
    padding rows too), K and V at the valid keys only, and of each bias
    row the terms that reach a valid key. The row is SAM @768's global shape
    in bf16, the main path's: the 2304 query rows ``WindowedAttention.
    _flash`` passes against the 48 x 64 padded key grid; ``fp32`` and
    ``by_shape`` hold the others, among them the same call with the queries
    padded to 3072 as JAX pads them (``sam768_padded``, the bound the same).
    The bodies: the Hopper kernel for bf16 at @768 and in ``kv_len`` mode
    (no bias: 64-key tiles up to kv_len), the register-tiled forward for
    fp32 at D 64 (in window mode one (batch, window, head) a problem); the
    ``window`` shape (100 windows of 16 x 16 tokens, 14 x 14 valid) takes
    K1's whole-window body in bf16 (``hopper_window``). That shape checks
    the ``window_tokens`` mode, which only ``WindowedAttention``'s
    ``window_group`` > 1 reaches (JAX's default is 1, and no entry point
    of either package sets it), so no path of the port runs it. The @768
    global shape at the same width in 24 heads of 32 and in 6 heads of 128
    (``sam768_d32``, ``sam768_d128``) times K3's other head dims, which
    keep the loops in both dtypes; no model of the repo has them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    bf16, fp32 = torch.bfloat16, torch.float32
    # B, heads, D, Sq, Sk, Kh, Kw, kv_grid, kv_len, window_tokens, dtypes
    shapes = {"sam768_global": (4, 12, 64, 2304, 3072, 48, 64, (48, 48),
                                None, None, (bf16, fp32)),
              "sam768_padded": (4, 12, 64, 3072, 3072, 48, 64, (48, 48),
                                None, None, (bf16,)),
              "kv_len": (4, 12, 64, 1370, 1536, 0, 0, None, 1370, None,
                         (bf16,)),
              "window": (25, 12, 64, 1024, 1024, 16, 16, (14, 14), None, 256,
                         (bf16, fp32)),
              "sam768_d32": (4, 24, 32, 2304, 3072, 48, 64, (48, 48), None,
                             None, (bf16, fp32)),
              "sam768_d128": (4, 6, 128, 2304, 3072, 48, 64, (48, 48), None,
                              None, (bf16, fp32))}
    # shape -> (bf16 body, fp32 body)
    bodies = {"sam768_global": ("hopper", "tiled"),
              "sam768_padded": ("hopper", None),
              "kv_len": ("hopper", None),
              "window": ("hopper_window", "tiled"),
              "sam768_d32": ("loops", "loops"),
              "sam768_d128": ("loops", "loops")}
    rows = {}
    for shape, (b, heads, d, sq, sk, kh, kw, grid, kv_len, win,
                dtypes) in shapes.items():
        scale = d ** -0.5
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
            want = bodies[shape][dtype == fp32]
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
            # the bytes: K and V at the n_valid keys of each window (or
            # sequence), the bias terms of the kv_grid's rows and columns
            segs = b * heads * (sk // (win or sk))
            terms = (min(grid[0], kh) + min(grid[1], kw) if grid
                     else kh + kw)
            nbytes = (_nbytes(q, kl, out) + (2 * segs * n_valid * d
                      + b * heads * sq * terms) * q.element_size())
            # the query rows the path keeps: as many as the valid keys of
            # a row (or of a window)
            rows[shape, dname] = _record(
                tag, "flash_attention.cu",
                "vit_deep_radiomics_tpu/ops/attention.py:87", dname, err,
                cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 2), lib,
                nbytes,
                4.0 * b * heads * (sq // (win or sq)) * n_valid * n_valid * d,
                peaks)
            rows[shape, dname]["body"] = body
            del q, k, v, bh, bw, kl, out
            torch.cuda.empty_cache()
    rec = dict(rows["sam768_global", "bfloat16"], name="flash_attention")
    rec["fp32"] = _sub(rows["sam768_global", "float32"])
    rec["fp32_body"] = rows["sam768_global", "float32"]["body"]
    rec["by_shape"] = {f"{shape} {dname}": dict(_sub(r), body=r["body"])
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


def k7_f32_wide_phase(torch, peaks):
    """Phase 16, fp32 at C 1536: K7 at DINOv2 ViT-g/14's rows at batch 4
    (4 x 1370, hidden 6144, with layerscale), fp32 inputs and weights, its
    C entry asked for the body ("loops": 16-row blocks, 8-unit hidden
    chunks), against its plain version; the library time is the unfused
    PyTorch path in fp32 with TF32 off. On no path of the port: its row's
    launches are 0."""
    import torch.nn.functional as F
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    b, s, c, hidden = K7_F32_WIDE
    eps = 1e-6

    def rand(*sh, sc=1.0):
        return torch.randn(*sh, generator=gen, device="cuda") * sc

    w1, w2 = rand(hidden, c, sc=c ** -0.5), rand(c, hidden, sc=hidden ** -0.5)
    b1, b2 = rand(hidden, sc=0.02), rand(c, sc=0.02)
    ln_s, ln_b, ls = 1.0 + rand(c, sc=0.1), rand(c, sc=0.1), \
        0.1 + rand(c, sc=0.02)
    x = rand(b, s, c)
    args = (x, ln_s, ln_b, w1.t(), b1, w2.t(), b2, ls)
    tag = f"fused_ln_mlp_residual [fp32, dinov2_vitg14, {b}x{s} rows, C {c}"
    body = M.fused_ln_mlp_residual_route(*args)
    if body != "loops":
        raise AssertionError(f"K7 fp32 at C {c} takes the {body} body")
    tag += f", {body}]"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = M.fused_ln_mlp_residual(*args, eps=eps)
        torch.cuda.synchronize()
        err = _check_outputs(
            torch, tag, [out],
            [M.fused_ln_mlp_residual_plain(*args, eps=eps)], ["out"], 0.0,
            K7_F32_ATOL)

        def unfused():
            y = F.layer_norm(x, (c,), ln_s, ln_b, eps)
            o = F.linear(F.gelu(F.linear(y, w1, b1), approximate="tanh"),
                         w2, b2)
            return x + o * ls

        rec = _record(
            tag, "fused_ln_mlp_residual.cu",
            "vit_deep_radiomics_tpu/ops/mlp_fused.py:47", "float32", err,
            cuda_ms(torch, lambda: M.fused_ln_mlp_residual(*args, eps=eps),
                    3),
            cuda_ms(torch, lambda: M.fused_ln_mlp_residual_plain(
                *args, eps=eps), 3),
            (cuda_ms(torch, unfused, 5), None),
            _nbytes(x, ln_s, ln_b, w1, b1, w2, b2, ls, out),
            4.0 * b * s * c * hidden, peaks,
            library="unfused PyTorch fp32, TF32 off: LayerNorm, 2 cuBLAS "
                    "GEMMs, tanh GELU, residual")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del x, args, out
    torch.cuda.empty_cache()
    return dict(rec, name="fused_ln_mlp_residual_f32_c1536", body=body,
                launches=0, path="none (JAX's own fp32 test at C 1536)")


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
    B=4 forward with 40 K7 and 40 K2 launches and the same forward
    unfused; at batch 1 held against the unfused forward, and both held to
    a ``parity`` forward on the same weights; one extraction); ViT-L/14
    ``full`` also under ``int8`` at batch 1 against a ``parity``
    plain-attention forward. Returns each path's record."""
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

    def hold_parity(label, cfg, got, ref):
        """Batch 1: the fused (``got``) and unfused (``ref``) forwards
        against a ``parity`` (fp32) forward on the same weights; the fused
        error may be at most VITG_PARITY_RATIO times the unfused one."""
        par = vit.ViTDense(cfg, policy=precision.PARITY)
        par.load_state_dict(state)
        with torch.no_grad():
            want = par.cuda().eval()(images[:1]).float()
        del par
        fused = (got - want).abs().max().item()
        unfused = (ref - want).abs().max().item()
        log(f"forward {label} B=1 vs parity: fused max abs err {fused:.3e}, "
            f"unfused {unfused:.3e} (ratio {fused / unfused:.3f}, limit "
            f"{VITG_PARITY_RATIO}) on max |x| {want.abs().max().item():.3f}")
        if not fused <= VITG_PARITY_RATIO * unfused:
            raise AssertionError(f"{label}: the fused forward is further from "
                                 f"parity ({fused}) than {VITG_PARITY_RATIO} "
                                 f"times the unfused one ({unfused})")
        return {"fused_max_abs_err": fused, "unfused_max_abs_err": unfused}

    def hold_int8(label, cfg):
        """Batch 1 under ``int8`` (K8 in each block's five projections, K2
        in each layer, launches asserted) against a ``parity``
        plain-attention forward on the same weights: the smallest
        per-position cosine above INT8_MIN_COSINE, as phase 18 holds SAM."""
        q8 = vit.ViTDense(cfg, policy=precision.INT8)
        q8.load_state_dict(state)
        q8 = q8.cuda().eval()
        A.reset_launch_counts()
        with torch.no_grad():
            got = q8(images[:1]).float()
        torch.cuda.synchronize()
        n = dict(A.LAUNCHES)
        del q8
        par = vit.ViTDense(cfg, policy=precision.PARITY, use_flash=False)
        par.load_state_dict(state)
        with torch.no_grad():
            want = par.cuda().eval()(images[:1]).float()
        del par
        cos = _min_cosine(got, want)
        log(f"forward {label} int8 B=1 vs parity plain attention: smallest "
            f"per-position cosine {cos:.6f} (limit > {INT8_MIN_COSINE}); "
            f"launches {n}")
        want_n = expect(dict(int8_matmul=5 * cfg.depth,
                             fused_global_attention=cfg.depth))
        if n != want_n:
            raise AssertionError(f"{label} int8: launches {n} != {want_n}")
        if tuple(got.shape) != tuple(want.shape) or \
                not bool(torch.isfinite(got).all()) or \
                not cos > INT8_MIN_COSINE:
            raise AssertionError(f"{label} int8 forward: cosine {cos}")
        return {"min_cosine": cos, "launches": n}

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
            if env:          # the same forward unfused, for comparison
                rec["forward_unfused"] = forward(
                    f"{label} unfused", model, {},
                    dict(fused_global_attention=launches[
                        "fused_global_attention"]), cfg.width)
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
            del model
            torch.cuda.empty_cache()
            if env:
                rec["b1_vs_parity"] = hold_parity(label, cfg, got, ref)
            del got, ref
            torch.cuda.empty_cache()
            if not env:
                rec["int8_b1"] = hold_int8(label, cfg)
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


def _token_items(ds, rng, n, dim):
    """``n`` TokenItems from ``rng`` at ``CLS_ITEMS``'s lengths, labels
    alternating (balanced)."""
    items = []
    for i in range(n):
        lc = int(rng.integers(CLS_ITEMS["ct"][0], CLS_ITEMS["ct"][1] + 1))
        lp = int(rng.integers(CLS_ITEMS["pet"][0], CLS_ITEMS["pet"][1] + 1))
        items.append(ds.TokenItem(
            rng.standard_normal((lc, dim), dtype=np.float32),
            rng.standard_normal((lp, dim), dtype=np.float32),
            np.eye(2, dtype=np.float32)[i % 2], f"P{i:03d}"))
    return items


def _classifier_epoch(T, ds, cfg, label, items, **tcfg):
    """One train epoch of a fresh ``FoldTrainer`` (seeded weights) on
    ``items``: the epoch's loss, finite, and the parameters moved."""
    trainer = T.FoldTrainer(cfg, T.TrainerConfig(**tcfg))
    trainer.init_params()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    batches = list(ds.batch_items(T._bucket_sorted(items),
                                  trainer.tcfg.batch_size))
    t0 = time.perf_counter()
    loss, _, scores, _ = trainer.run_epoch(batches, 0, train=True,
                                           rng_seed=SEED)
    dt = time.perf_counter() - t0
    moved = max((v - before[k]).abs().max().item()
                for k, v in trainer.model.state_dict().items())
    log(f"classifier {label}: {len(batches)} micro-batches in "
        f"{dt * 1e3:.1f} ms, loss {loss:.6g}, max parameter move "
        f"{moved:.3e}")
    if not (np.isfinite(loss) and np.isfinite(scores).all() and moved > 0):
        raise AssertionError(f"classifier {label}: non-finite or no update")
    return {"micro_batches": len(batches), "ms": dt * 1e3, "loss": loss,
            "moved": moved}


def _parity_grads(torch, T, cfg, state, batch, device):
    """One ``parity`` micro-batch step of the bimodal classifier (dropout
    off) on ``device`` at the weights ``state``: (loss, {leaf: grad})."""
    trainer = T.FoldTrainer(cfg, T.TrainerConfig(precision="parity",
                                                 device=device))
    trainer.model.dropout_rate = 0.0
    trainer.init_params(state)
    with trainer.policy.backends():
        loss, _ = trainer.step(batch, scale=1.0 / 32, train=True)
    return float(loss), {k: p.grad.detach().cpu()
                         for k, p in trainer.model.named_parameters()}


def classifier_phase(torch, A):
    """Phase 21: classifier training on the descriptors at the published
    transformer config (feature_dim 256, CT and PET encoders of 2 layers x
    4 heads, FFN 1024; ``TrainerConfig``'s defaults: bimodal, cross-modal
    focal loss, batch 8, ``fast``; virtual batch 32, so 4 micro-batches an
    update) from in-memory ``TokenItem``s (the card has no HDF5): a train
    and a test epoch through ``FoldTrainer`` and ``FoldBookkeeping`` (report
    JSONs, ``losses.html``, a checkpoint reloaded into a fresh model that
    gives the same test logits), a timed second train epoch, a profiled
    micro-batch step, one epoch each of the unimodal ``ct`` transformer
    and of the conv classifier, and a ``parity`` micro-batch step on the
    card against the CPU's. No kernel of K1-K8 runs."""
    from vit_deep_radiomics_tpu_torch.analysis import reports
    from vit_deep_radiomics_tpu_torch.data import datasets as ds
    from vit_deep_radiomics_tpu_torch.engine import checkpoint as ck
    from vit_deep_radiomics_tpu_torch.engine import train as T
    from vit_deep_radiomics_tpu_torch.utils.profiling import trace_runs

    cfg = CLASSIFIER_CFG
    dim = cfg["models"]["transformer"]["feature_dim"]
    rng = np.random.default_rng(SEED)
    train_items = _token_items(ds, rng, CLS_ITEMS["train"], dim)
    test_items = _token_items(ds, rng, CLS_ITEMS["test"], dim)
    A.reset_launch_counts()
    trainer = T.FoldTrainer(cfg, T.TrainerConfig())
    trainer.init_params()
    tc = trainer.tcfg
    bsz = tc.batch_size
    train_batches = list(ds.batch_items(T._bucket_sorted(train_items), bsz))
    test_batches = list(ds.batch_items(T._bucket_sorted(test_items), bsz))
    buckets = sorted({(b["ct"].shape[1], b["pet"].shape[1])
                      for b in train_batches + test_batches})
    accum = min(-(-trainer.virtual_batch // bsz), len(train_batches))
    log(f"classifier {tc.arch}/{tc.modality}/{tc.loss} {tc.precision}: "
        f"{len(train_items)} train and {len(test_items)} test items, batch "
        f"{bsz}, {len(train_batches)} micro-batches an epoch, "
        f"{len(train_batches) // accum} updates (virtual batch "
        f"{trainer.virtual_batch}), (CT, PET) buckets {buckets}")
    if max(max(b) for b in buckets) > MAX_TOKENS:
        raise AssertionError(f"classifier buckets {buckets}")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    save_dir = Path(tempfile.mkdtemp(prefix="vdr_classifier_"))
    history = {k: [] for k in T.HISTORY_KEYS}
    book = T.FoldBookkeeping(history, trainer.patience, save_dir, 0,
                             tc.dataset, log=lambda *_: None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = trainer.run_epoch(train_batches, 0, train=True, rng_seed=tc.seed)
    warm = time.perf_counter() - t0
    te = trainer.run_epoch(test_batches, 0, train=False)
    reps = [reports.device_epoch_report(
        y, s, T._patient_weights(p), kfold=0, loss=loss, epoch=0,
        split=split, device=trainer.device)
        for split, (loss, y, s, p) in (("train", tr), ("test", te))]
    book.record_epoch(0, tr[0], te[0], *reps, trainer.checkpoint_state)
    ck.wait_pending()
    with torch.no_grad():
        ref_logits = torch.cat([trainer.step(b)[1] for b in test_batches])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr1 = trainer.run_epoch(train_batches, 1, train=True, rng_seed=tc.seed)
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    moved = max((v - before[k]).abs().max().item()
                for k, v in trainer.model.state_dict().items())
    step_ms = epoch_s * 1e3 / len(train_batches)
    log(f"classifier epochs: train 0 loss {tr[0]:.6g} ({warm * 1e3:.1f} ms, "
        f"warm-up), test 0 loss {te[0]:.6g}, train 1 loss {tr1[0]:.6g}; "
        f"train AUC {reps[0]['ROC AUC']:.4f} macro F1 "
        f"{reps[0]['macro avg']['f1-score']:.4f}, test AUC "
        f"{reps[1]['ROC AUC']:.4f} macro F1 "
        f"{reps[1]['macro avg']['f1-score']:.4f}")
    log(f"classifier step (epoch 1, host clock): {step_ms:.3f} ms per "
        f"micro-batch of {bsz}, {len(train_items) / epoch_s:.2f} samples/s, "
        f"peak memory {peak / 2 ** 30:.3f} GiB; max parameter move "
        f"{moved:.3e}")
    if not (all(np.isfinite(x[0]) for x in (tr, te, tr1)) and moved > 0):
        raise AssertionError("classifier: non-finite loss or no update")

    files = sorted(p.name for p in save_dir.iterdir())
    want = ["history_0000.json", "losses.html", "model_epoch_0000.pt",
            "test_metrics_0.json", "train_metrics_0.json"]
    log(f"classifier bookkeeping wrote {files}")
    if files != want:
        raise AssertionError(f"classifier files {files} != {want}")
    fresh = T.FoldTrainer(cfg, T.TrainerConfig())
    fresh.init_params()
    state = ck.load_checkpoint(save_dir, 0, map_location="cuda")
    fresh.load_state(state)
    with torch.no_grad():
        got = torch.cat([fresh.step(b)[1] for b in test_batches])
    reload_err = (got - ref_logits).abs().max().item()
    log(f"classifier checkpoint reload: test logits max |diff| "
        f"{reload_err:.3e}")
    if reload_err != 0.0:
        raise AssertionError("the reloaded checkpoint's logits differ")
    del fresh, state, got

    # the micro-batch step at the largest bucket, traced
    big = train_batches[-1]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def micro_step():
        with trainer.policy.backends():
            trainer.step(big, 1.0 / (accum * bsz), True, gen)

    prof = trace_runs(micro_step, 3, 8, what="classifier micro-batch",
                      buckets=(big["ct"].shape[1], big["pet"].shape[1]))
    trainer.optimizer.zero_grad(set_to_none=True)
    log(f"classifier micro-batch (CT {prof['buckets'][0]}, PET "
        f"{prof['buckets'][1]}, B={bsz}) traced: wall {prof['wall_ms']:.3f} "
        f"ms, device {prof['device_ms']:.3f} ms, idle share "
        f"{prof['idle_share']:.3f}; top " + "; ".join(
            f"{r['name'][:60]} {r['ms']:.3f} ms ({r['calls']:.0f}x)"
            for r in prof["top"]))

    uni = _classifier_epoch(T, ds, cfg, "transformer/ct/focal", train_items,
                            modality="ct", loss="focal")
    crng = np.random.default_rng(SEED + 1)
    cdim = cfg["models"]["conv"]["feature_dim"]
    lo, hi = CLS_ITEMS["conv_slices"]
    conv_items = []
    for i in range(CLS_ITEMS["conv_train"]):
        vol = crng.standard_normal((int(crng.integers(lo, hi + 1)), 16, 16,
                                    cdim), dtype=np.float32)
        conv_items.append(ds.TokenItem(
            vol, vol, np.eye(2, dtype=np.float32)[i % 2], f"C{i:03d}"))
    conv = _classifier_epoch(T, ds, cfg, "conv/ct/focal", conv_items,
                             arch="conv", modality="ct", loss="focal")

    # `parity` on the card against the CPU: the smallest batch, the
    # trained weights
    state = {k: v.detach().cpu() for k, v in
             trainer.model.state_dict().items()}
    batch = train_batches[0]
    loss_c, g_c = _parity_grads(torch, T, cfg, state, batch, "cuda")
    t0 = time.perf_counter()
    loss_h, g_h = _parity_grads(torch, T, cfg, state, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    worst, worst_name = abs(loss_c - loss_h) / abs(loss_h), "loss"
    for k, ref in g_h.items():
        scale = ref.abs().max().item()
        err = (g_c[k] - ref).abs().max().item()
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else
                                               float("inf"))
        if ratio > worst:
            worst, worst_name = ratio, k
    log(f"classifier parity step (CT {batch['ct'].shape[1]}, PET "
        f"{batch['pet'].shape[1]}, B={bsz}), card vs CPU ({cpu_s:.1f} s): "
        f"loss {loss_c:.8g} vs {loss_h:.8g}; {len(g_h)} leaves, worst "
        f"|diff| / leaf max |grad| {worst:.3e} ({worst_name}), limit "
        f"{CLS_PARITY_REL:g}")
    if not worst <= CLS_PARITY_REL:
        raise AssertionError(f"classifier parity: {worst_name} at {worst:.3e}")
    counts = dict(A.LAUNCHES)
    if any(counts.values()):
        raise AssertionError(f"classifier phase launched kernels: {counts}")
    shutil.rmtree(save_dir)
    del trainer
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "samples_s": len(train_items) / epoch_s,
            "peak_gib": peak / 2 ** 30, "losses": [tr[0], te[0], tr1[0]],
            "test_auc": reps[1]["ROC AUC"],
            "test_f1": reps[1]["macro avg"]["f1-score"],
            "profile": {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "idle_share")},
            "unimodal": uni, "conv": conv, "parity_worst": worst}


def _check_launches(A, label: str, expect: dict) -> dict:
    """The launches since the last reset: exactly ``expect``."""
    counts = {k: v for k, v in A.LAUNCHES.items() if v}
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != {expect}")
    return counts


def _serve_cli(cs, argv) -> list[str]:
    """Run the serve CLI in this process; its stdout lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cs.main(argv)
    if rc != 0:
        raise AssertionError(f"serve {argv[0]} exited {rc}")
    return buf.getvalue().strip().splitlines()


def _baked_twin(torch, es, vit, meta, backbone, device):
    """A live ViTDense built from an artifact's header and the baked state
    dict of its loaded backbone (its routing read from the environment)."""
    cfg = dict(meta["config"])
    cfg["global_indexes"] = tuple(cfg["global_indexes"])
    twin = vit.ViTDense(vit.ViTDenseConfig(**cfg),
                        policy=es.get_policy(meta["policy"]))
    twin.to(torch.bfloat16).load_state_dict(backbone.state_dict())
    return twin.to(device).eval()


def _serve_dense(torch, A, cs, es, vit, tmp, device):
    """Phase 22 (a): export SAM ViT-B/16 @1024 `fast` at B=4 with the CLI,
    `serve run` over 8 batches, the output against a ViTDense on the same
    baked weights (bit for bit), one call's launches, and one call from
    host images traced."""
    from vit_deep_radiomics_tpu_torch.utils.profiling import trace_runs

    art = str(tmp / "sam_fast_b4.vdr")
    t0 = time.perf_counter()
    _serve_cli(cs, ["export", "-mn", "medsam", "-o", art, "-b",
                    str(SERVE_BATCH), "--precision", "fast", "--device",
                    device])
    export_s = time.perf_counter() - t0
    size = es.read_header(art)["image_size"]
    images = np.random.default_rng(SEED).random(
        (SERVE_BATCH * SERVE_BATCHES, size, size, 3), dtype=np.float32)
    np.save(tmp / "images.npy", images)
    report = json.loads(_serve_cli(cs, [
        "run", art, "-i", str(tmp / "images.npy"), "-o",
        str(tmp / "features.npy"), "--device", device])[-1])
    mib = Path(art).stat().st_size / 2 ** 20
    log(f"serve dense: export {export_s:.2f} s ({mib:.1f} MiB); run: "
        f"exec_cache {report['exec_cache']}, "
        f"warm {report['warm_s']} s (build {report['warm_build_s']} s of "
        f"{report['built']}, first call {report['warm_first_exec_s']} "
        f"s), {report['images']} images in {report['seconds']} s, "
        f"{report['img_per_s']} img/s, latency p50 "
        f"{report['latency_p50_ms']} ms, p90 {report['latency_p90_ms']} "
        f"ms (first batch {report['first_batch_ms']} ms)")
    feats = np.load(tmp / "features.npy")
    model = es.load_exported(art, device=device)
    twin = _baked_twin(torch, es, vit, model.meta, model.module, device)
    with torch.no_grad():
        want = twin(torch.from_numpy(images[:SERVE_BATCH]).to(device))
    if not np.array_equal(feats[:SERVE_BATCH], want.cpu().numpy()):
        raise AssertionError(
            "serve dense: the artifact's output differs from a ViTDense on "
            "its baked weights by "
            f"{np.abs(feats[:SERVE_BATCH] - want.cpu().numpy()).max():.3e}")
    A.reset_launch_counts()
    model(images[:SERVE_BATCH]).cpu()
    counts = _check_launches(A, "serve dense", SERVE_LAUNCHES["dense"])
    prof = trace_runs(lambda: model(images[:SERVE_BATCH]), 3, 6,
                      what="served dense batch")
    log(f"serve dense: output equal to the ViTDense twin bit for bit; "
        f"launches per call {counts}; one call from host images traced: "
        f"wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} "
        f"ms, idle share {prof['idle_share']:.3f}; top " + "; ".join(
            f"{r['name'][:50]} {r['ms']:.3f} ms ({r['calls']:.0f}x)"
            for r in prof["top"]))
    return {"export_s": export_s, "run": report, "launches": counts,
            "profile": {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "idle_share")}}


def _serve_inputs(rng, g: int) -> dict:
    """One bimodal raw-HU request in ``in_spec`` order: CT int16 HU and
    PET float32 activity at their native sizes, a nodule disc on the
    descriptor grid through every slice of each stack, spacings (mm)."""
    vols, masks = {}, {}
    yy, xx = np.mgrid[:g, :g]
    for mod in ("ct", "pet"):
        s, n = SERVE_SLICES[mod], SERVE_NATIVE[mod]
        vols[mod] = (rng.integers(-1024, 1500, (1, s, n, n)).astype(np.int16)
                     if mod == "ct" else
                     rng.gamma(2.0, 1.5, (1, s, n, n)).astype(np.float32))
        cy, cx = rng.integers(g // 4, 3 * g // 4, size=2)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= SERVE_RADII[mod] ** 2
        masks[mod] = np.broadcast_to(disc, (1, s, g, g)).copy()
    return {"ct_images": vols["ct"], "pet_images": vols["pet"],
            "ct_grid_mask": masks["ct"], "pet_grid_mask": masks["pet"],
            "ct_res": np.asarray([[0.7, 0.7, 1.25]], np.float32),
            "pet_res": np.asarray([[4.0, 4.0, 3.0]], np.float32)}


def _two_stage(torch, pp, ds, twin, clf, inputs, meta, device):
    """The reference's two stages on one request: each stack normalised
    (``ops/preprocess.py``) through the backbone, the trainer's tokens on
    the host (``data/datasets.py::voxel_tokens``) padded to the budget,
    then the classifier."""
    toks, valid = [], []
    for mod in ("ct", "pet"):
        vol = torch.from_numpy(inputs[f"{mod}_images"][0]).to(device).float()
        x = (pp.apply_window_ct(vol, *meta["ct_window"]) if mod == "ct"
             else pp.normalize_pet(vol))
        with torch.no_grad():
            feats = twin(pp.prepare_vit_input(x, meta["image_size"]))
        mask = inputs[f"{mod}_grid_mask"][0]
        tok = ds.voxel_tokens(feats.float().cpu().numpy(),
                              mask.astype(np.float32), mask.shape[1:],
                              inputs[f"{mod}_res"][0])
        n, t = tok.shape[0], meta["max_tokens"]
        if n > t:
            raise AssertionError(f"serve: {n} {mod} tokens over the budget")
        padded = np.zeros((1, t, tok.shape[1]), np.float32)
        padded[0, :n] = tok
        toks.append(torch.from_numpy(padded).to(device))
        valid.append(torch.arange(t, device=device)[None] < n)
    with torch.no_grad():
        out = clf(ct_tokens=toks[0], pet_tokens=toks[1], ct_mask=valid[0],
                  pet_mask=valid[1])
    return [o.float().cpu().numpy() for o in out]


def _http(url, body=None):
    """(status, body) of a GET, or of a POST when ``body`` is given."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _serve_pipeline(torch, A, cs, es, vit, tmp, device):
    """Phase 22 (b): the bimodal raw-HU pipeline at the published
    classifier config on `ThreadingHTTPServer`: health, a malformed body
    (400), an unknown path (404), ``SERVE_REQUESTS`` requests held to the
    two-stage path, one request's launches, the wall latencies, one
    request traced in process and the peak memory."""
    import io
    import threading
    from http.server import ThreadingHTTPServer

    from vit_deep_radiomics_tpu_torch.data import datasets as ds
    from vit_deep_radiomics_tpu_torch.engine import extract as tex
    from vit_deep_radiomics_tpu_torch.models import classifiers as C
    from vit_deep_radiomics_tpu_torch.ops import preprocess as pp
    from vit_deep_radiomics_tpu_torch.utils.profiling import (
        memory_summary_gib, trace_runs)

    backbone = tex.DenseExtractor(tex.ExtractionConfig(), device=device)
    clf = C.init_classifier(C.build_classifier(
        CLASSIFIER_CFG, "transformer", "petct"), SEED)
    art = es.export_pipeline(
        backbone.model.state_dict(), backbone.backbone_cfg,
        clf.state_dict(), CLASSIFIER_CFG, "transformer", "petct",
        tmp / "petct_raw_hu.vdr", slices=SERVE_SLICES["ct"],
        pet_slices=SERVE_SLICES["pet"], max_tokens=SERVE_MAX_TOKENS,
        batch=1, policy="fast", input_mode="raw_hu",
        native_size=SERVE_NATIVE["ct"], pet_native_size=SERVE_NATIVE["pet"])
    del backbone, clf
    model = es.load_exported(art, device=device)
    t0 = time.perf_counter()
    model.warm()
    warm_s = time.perf_counter() - t0
    meta = model.meta
    log(f"serve pipeline: {meta['model']} @{meta['image_size']} "
        f"{meta['policy']} -> {meta['arch']}/{meta['modality']} raw-HU "
        f"(CT {meta['in_spec']['ct_images']}, PET "
        f"{meta['in_spec']['pet_images']}, {meta['max_tokens']} tokens); "
        f"warm {warm_s:.2f} s, exec_cache {model.cache_status}, "
        f"{model.warm_stats}")
    rng = np.random.default_rng(SEED + 22)
    requests = [_serve_inputs(rng, meta["grid"])
                for _ in range(SERVE_REQUESTS)]
    bodies = []
    for inputs in requests:
        buf = io.BytesIO()
        np.savez(buf, **inputs)
        bodies.append(buf.getvalue())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), cs.make_server(model))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    walls, responses = [], []
    try:
        code, body = _http(url + "/health")
        if code != 200 or json.loads(body)["status"] != "ok":
            raise AssertionError(f"serve /health: {code} {body[:200]}")
        code, body = _http(url + "/infer", b"not-an-npz")
        if code != 400 or "error" not in json.loads(body):
            raise AssertionError(f"serve malformed body: {code}")
        code, _ = _http(url + "/nowhere")
        if code != 404:
            raise AssertionError(f"serve unknown path: {code}")
        torch.cuda.reset_peak_memory_stats()
        for i, body in enumerate(bodies):
            if i == 1:
                A.reset_launch_counts()
            t0 = time.perf_counter()
            code, resp = _http(url + "/infer", body)
            walls.append(time.perf_counter() - t0)
            if i == 1:
                counts = _check_launches(A, "serve request",
                                         SERVE_LAUNCHES["pipeline"])
            if code != 200:
                raise AssertionError(f"serve request {i}: {code} "
                                     f"{resp[:300]}")
            with np.load(io.BytesIO(resp)) as z:
                responses.append([z[n] for n in meta["out_names"]])
        peak = memory_summary_gib(device)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    steady = np.asarray(walls[1:]) * 1e3
    prof = trace_runs(lambda: model(*requests[0].values()), 3, 8,
                      what="served request")
    # `serve run --overlap` on three of the requests: the next batch's
    # copy from pinned memory on a side stream, the same outputs
    np.savez(tmp / "requests.npz", **{
        k: np.concatenate([r[k] for r in requests[:3]]) for k in requests[0]})
    overlap = json.loads(_serve_cli(cs, [
        "run", art, "-i", str(tmp / "requests.npz"), "-o",
        str(tmp / "outputs.npz"), "--overlap", "--device", device])[-1])
    with np.load(tmp / "outputs.npz") as z:
        for i, got in enumerate(responses[:3]):
            if not all(np.array_equal(z[n][i], g[0])
                       for n, g in zip(meta["out_names"], got)):
                raise AssertionError(f"serve run --overlap: item {i} "
                                     "differs from its HTTP response")

    twin = _baked_twin(torch, es, vit, meta, model.module.vit, device)
    ref_clf = C.build_classifier(CLASSIFIER_CFG, "transformer", "petct")
    ref_clf.to(torch.bfloat16).load_state_dict(model.module.clf.state_dict())
    ref_clf = ref_clf.to(device).eval()
    gaps = []
    for inputs, got in zip(requests, responses):
        want = _two_stage(torch, pp, ds, twin, ref_clf, inputs, meta,
                          device)
        if not all(np.isfinite(g).all() and g.shape == w.shape
                   for g, w in zip(got, want)):
            raise AssertionError("serve: non-finite or misshapen outputs")
        gaps.append(max(float(np.abs(g - w).max())
                        for g, w in zip(got, want)))
    log(f"serve pipeline: {len(walls)} requests over HTTP, wall first "
        f"{walls[0] * 1e3:.3f} ms, then p50 "
        f"{np.percentile(steady, 50):.3f} ms, p90 "
        f"{np.percentile(steady, 90):.3f} ms; launches per request "
        f"{counts}; peak memory {peak}; one request in process traced: "
        f"wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} "
        f"ms, idle share {prof['idle_share']:.3f}; top " + "; ".join(
            f"{r['name'][:50]} {r['ms']:.3f} ms ({r['calls']:.0f}x)"
            for r in prof["top"]))
    log(f"serve pipeline: `serve run --overlap` over 3 requests equals "
        f"their HTTP responses; {overlap['items_per_s']} items/s, latency "
        f"p50 {overlap['latency_p50_ms']} ms")
    log(f"serve pipeline vs the two-stage path: max |diff| per request "
        f"{[f'{g:.3e}' for g in gaps]}, limit {SERVE_ATOL:g}")
    if not max(gaps) <= SERVE_ATOL:
        raise AssertionError(f"serve pipeline: gap {max(gaps):.3e}")
    return {"warm_s": warm_s, "warm_stats": model.warm_stats,
            "cache_status": model.cache_status,
            "wall_first_ms": walls[0] * 1e3,
            "wall_p50_ms": float(np.percentile(steady, 50)),
            "wall_p90_ms": float(np.percentile(steady, 90)),
            "launches": counts, "peak": peak, "max_gap": max(gaps),
            "overlap_items_s": overlap["items_per_s"],
            "profile": {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "idle_share")}}


def _serve_routing(torch, A, cs, es, tmp, device):
    """Phase 22 (c): a dense artifact exported under ``VDR_FUSED_MLP=1``
    and served with it unset runs K7 in every block: the header governs."""
    art = str(tmp / "sam_fast_fused_b1.vdr")
    os.environ["VDR_FUSED_MLP"] = "1"
    try:
        _serve_cli(cs, ["export", "-mn", "medsam", "-o", art, "-b", "1",
                        "--precision", "fast", "--device", device])
    finally:
        os.environ.pop("VDR_FUSED_MLP")
    model = es.load_exported(art, device=device).warm()
    size = model.meta["image_size"]
    A.reset_launch_counts()
    model(np.random.default_rng(SEED).random(
        (1, size, size, 3), dtype=np.float32)).cpu()
    counts = _check_launches(A, "serve routing", SERVE_LAUNCHES["fused_mlp"])
    log(f"serve routing: kernel_env {model.meta.get('kernel_env')}, served "
        f"without it: launches {counts}, warm {model.warm_stats}")
    return {"launches": counts}


def _serve_kernels(torch, A) -> dict:
    """Phase 22's kernels at ``SERVE_KERNEL_SHAPES`` in bf16 against their
    plain versions on the same inputs (phase 3's rule for K1 and K2,
    phase 16's for K7), each asked which body it takes: the body of the
    main path's shapes. K2's plain version runs four images at a time (the
    images are independent); each shape's kernel ms, bound, error and
    library ms (K1 and K2: SDPA, memory-efficient, the dense bias as a bf16
    ``attn_mask`` built outside the timed call; K7: the unfused path)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    peaks = peaks_for(torch.cuda.get_device_name(0))[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    dt, heads, d = torch.bfloat16, 12, 64
    c, scale = heads * d, d ** -0.5

    def rand(*shape, sc=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * sc).to(dt)

    def sdpa(q, kv, bh, bw):
        """SDPA on head-major views of one image or window each, the dense
        bias as ``attn_mask``: a timed call."""
        b, s = q.shape[:2]
        qh, kh_, vh = (_heads_of(t, 1, s, heads)
                       for t in (q, kv[..., :c], kv[..., c:]))
        mask = _dense_mask(bh, bw, 1, s, heads)

        def call():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(qh, kh_, vh,
                                                      attn_mask=mask,
                                                      scale=scale)
        return call

    def hold(name, tag, kern, plain, body, want, rtol, atol, nb, flops,
             lib):
        if body != want:
            raise AssertionError(f"{name} at the serving shape {tag} takes "
                                 f"the {body} body, not the {want} one")
        out = kern()
        torch.cuda.synchronize()
        err = _check_outputs(torch, f"{name} [serve {tag}]", [out],
                             [plain()], ["out"], rtol, atol)
        t_bytes, t_ops = nb / peaks[0] * 1e3, flops / peaks[1] * 1e3
        res = {"shape": list(out.shape), "body": body, "max_abs_err": err,
               "ms": cuda_ms(torch, kern, 10),
               "library_ms": cuda_ms(torch, lib, 10),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"kernel {name} [serve {tag}]: {res}")
        return res

    found = {name: {} for name in SERVE_KERNEL_SHAPES}
    for tag, b in SERVE_KERNEL_SHAPES["fused_window_attention"].items():
        s = 196
        q, kv = rand(b, s, c), rand(b, s, 2 * c)
        bh, bw = rand(b, heads, s, 14, sc=0.3), rand(b, heads, s, 14, sc=0.3)
        kw = dict(num_heads=heads, window_tokens=s, scale=scale)
        found["fused_window_attention"][tag] = hold(
            "fused_window_attention", f"{tag} {b} windows",
            lambda: A.fused_window_attention(q, kv, bh, bw, **kw),
            lambda: A.fused_window_attention_plain(q, kv, bh, bw, **kw),
            A.fused_window_attention_route(q, kv, bh, bw, **kw),
            BODIES["fused_window_attention"]["bfloat16"], RTOL["bfloat16"],
            ATOL["fused_window_attention"]["bfloat16"],
            _nbytes(q, q, kv, bh, bw), 4.0 * b * heads * s * s * d,
            sdpa(q, kv, bh, bw))
        del q, kv, bh, bw
    for tag, b in SERVE_KERNEL_SHAPES["fused_global_attention"].items():
        s = 4096
        q, kv = rand(b, s, c), rand(b, s, 2 * c)
        bh, bw = rand(b, heads, s, 64, sc=0.3), rand(b, heads, s, 64, sc=0.3)
        kw = dict(num_heads=heads, scale=scale)

        def plain():
            return torch.cat([A.fused_global_attention_plain(
                q[i:i + 4], kv[i:i + 4], bh[i:i + 4], bw[i:i + 4], None,
                **kw) for i in range(0, b, 4)])

        found["fused_global_attention"][tag] = hold(
            "fused_global_attention", f"{tag} batch {b}",
            lambda: A.fused_global_attention(q, kv, bh, bw, None, **kw),
            plain,
            A.fused_global_attention_route(q, kv, bh, bw, None, **kw),
            BODIES["fused_global_attention"]["bfloat16"], RTOL["bfloat16"],
            ATOL["fused_global_attention"]["bfloat16"],
            _nbytes(q, q, kv, bh, bw), 4.0 * b * heads * s * s * d,
            sdpa(q, kv, bh, bw))
        del q, kv, bh, bw
        torch.cuda.empty_cache()
    _, s, _, hidden, _, want = K7_SHAPES["sam"]
    for tag, b in SERVE_KERNEL_SHAPES["fused_ln_mlp_residual"].items():
        x = rand(b, s, c)
        w1, w2 = rand(hidden, c, sc=c ** -0.5), rand(c, hidden,
                                                     sc=hidden ** -0.5)
        ln_s = 1.0 + rand(c, sc=0.1).float()
        ln_b, b1, b2 = (rand(n, sc=sc).float() for n, sc in (
            (c, 0.1), (hidden, 0.02), (c, 0.02)))
        args = (x, ln_s, ln_b, w1.t(), b1, w2.t(), b2, None)
        p = [t.to(dt) for t in (ln_s, ln_b, b1, b2)]

        def unfused():
            y = F.layer_norm(x, (c,), p[0], p[1], 1e-6)
            return x + F.linear(F.gelu(F.linear(y, w1, p[2]),
                                       approximate="tanh"), w2, p[3])

        found["fused_ln_mlp_residual"][tag] = hold(
            "fused_ln_mlp_residual", f"{b}x{s} rows",
            lambda: M.fused_ln_mlp_residual(*args, eps=1e-6),
            lambda: M.fused_ln_mlp_residual_plain(*args, eps=1e-6),
            M.fused_ln_mlp_residual_route(*args), want, RTOL["bfloat16"],
            K7_ATOL, _nbytes(x, ln_s, ln_b, w1, b1, w2, b2, x),
            4.0 * b * s * c * hidden, unfused)
        del x, args
    torch.cuda.empty_cache()
    return found


def serving_phase(torch, A, device: str = "cuda") -> dict:
    """Phase 22: serving through the port's entry points (``cli.serve``,
    ``engine.serve``) at SAM ViT-B/16 @1024 `fast`: the kernels at the
    shapes serving gives them against their plain versions, then (a) the
    dense artifact, (b) the bimodal raw-HU pipeline at the published
    classifier config over HTTP, (c) the recorded kernel env routing the
    loaded model."""
    from vit_deep_radiomics_tpu_torch.cli import serve as cs
    from vit_deep_radiomics_tpu_torch.engine import serve as es
    from vit_deep_radiomics_tpu_torch.models import vit

    kernels = _serve_kernels(torch, A)
    tmp = Path(tempfile.mkdtemp(prefix="vdr_serve_"))
    try:
        dense = _serve_dense(torch, A, cs, es, vit, tmp, device)
        torch.cuda.empty_cache()
        pipeline = _serve_pipeline(torch, A, cs, es, vit, tmp, device)
        torch.cuda.empty_cache()
        routing = _serve_routing(torch, A, cs, es, tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"kernels": kernels, "dense": dense, "pipeline": pipeline,
            "routing": routing}


def _fold_items(ds, rng, n, dim, ct, pet, tag):
    """``n`` TokenItems from ``rng``: CT and PET lengths drawn from the
    inclusive ranges ``ct`` and ``pet`` (or fixed when an int), labels
    alternating."""
    def draw(r):
        return r if isinstance(r, int) else int(rng.integers(r[0], r[1] + 1))

    f32 = np.float32
    return [ds.TokenItem(rng.standard_normal((draw(ct), dim), dtype=f32),
                         rng.standard_normal((draw(pet), dim), dtype=f32),
                         np.eye(2, dtype=f32)[i % 2], f"{tag}{i:03d}")
            for i in range(n)]


def _lockstep(torch, T, FP, ds, ck, trace_runs, cfg, dim, device):
    """Phase 23 (a): the 5 folds in lockstep against the same folds one by
    one, and a fold's checkpoint round trip."""
    rng = np.random.default_rng(SEED + 23)
    train = [_fold_items(ds, rng, n, dim, CLS_ITEMS["ct"], CLS_ITEMS["pet"],
                         f"F{f}T") for f, n in enumerate(FOLD_TRAIN_ITEMS)]
    test = [_fold_items(ds, rng, FOLD_TEST_ITEMS, dim, CLS_ITEMS["ct"],
                        CLS_ITEMS["pet"], f"F{f}E")
            for f in range(len(FOLD_TRAIN_ITEMS))]
    tc = T.TrainerConfig(device=device)
    bsz = tc.batch_size
    train_fb = [list(ds.batch_items(T._bucket_sorted(it), bsz))
                for it in train]
    test_fb = [list(ds.batch_items(T._bucket_sorted(it), bsz)) for it in test]
    n_folds = len(train_fb)
    par = FP.ParallelFoldTrainer(cfg, tc, n_folds)
    par.init_stacked()
    steps = max(len(b) for b in train_fb)
    log(f"lockstep {tc.arch}/{tc.modality}/{tc.loss} {tc.precision}: "
        f"{n_folds} folds, train micro-batches {[len(b) for b in train_fb]}"
        f" (B={bsz}), {steps} lockstep steps an epoch, test "
        f"{[len(b) for b in test_fb]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = par.run_lockstep_epoch(train_fb, 0, True, rng_seed=tc.seed)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = par.run_lockstep_epoch(train_fb, 1, True, rng_seed=tc.seed)
    lock_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    te = par.run_lockstep_epoch(test_fb, 1, False)
    losses = [[r[0] for r in x] for x in (warm, tr, te)]
    n_micro = -(-par.virtual_batch // bsz)
    updates = [2 * -(-len(b) // min(n_micro, len(b))) for b in train_fb]
    if not all(np.isfinite(v) for row in losses for v in row) or \
            par.steps != updates:
        raise AssertionError(f"lockstep: losses {losses}, updates "
                             f"{par.steps}")

    # the host's share of a step that is not dispatch: stacking the folds'
    # batches, the bf16 cast and the copy to the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps):
        stacked, _ = FP.stack_fold_batches(
            [b[s] if s < len(b) else None for b in train_fb], bsz)
        par._model_inputs(stacked)
    torch.cuda.synchronize()
    stack_ms = (time.perf_counter() - t0) * 1e3 / steps

    # the same folds one by one: a warm epoch, then the timed one
    seq_s, seq_peak = 0.0, 0
    for f in range(n_folds):
        t = T.FoldTrainer(cfg, tc)
        t.init_params()
        t.run_epoch(train_fb[f], 0, True, rng_seed=tc.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t.run_epoch(train_fb[f], 1, True, rng_seed=tc.seed)
        seq_s += time.perf_counter() - t0
        seq_peak = max(seq_peak, torch.cuda.max_memory_allocated())
        del t
    ratio = lock_s / seq_s
    log(f"lockstep epoch 1 (host clock): {lock_s * 1e3:.1f} ms for "
        f"{n_folds} folds, {lock_s * 1e3 / steps:.3f} ms a lockstep step "
        f"(stacking, cast and copy {stack_ms:.3f} ms of it), peak memory "
        f"{peak / 2 ** 30:.3f} GiB (warm-up epoch {warm_s * 1e3:.1f} ms); "
        f"the same {n_folds} folds one by one {seq_s * 1e3:.1f} ms, peak "
        f"{seq_peak / 2 ** 30:.3f} GiB: lockstep / sequential {ratio:.3f}; "
        f"train losses {['%.6g' % v for v in losses[1]]}, test "
        f"{['%.6g' % v for v in losses[2]]}")

    # fold 2 through the port's checkpoint into a fresh FoldTrainer
    f = 2
    tmp = Path(tempfile.mkdtemp(prefix="vdr_foldpar_"))
    try:
        ck.save_checkpoint({**par.fold_state(f), "epoch": 1}, tmp, 1)
        fresh = T.FoldTrainer(cfg, tc)
        fresh.init_params()
        fresh.load_state(ck.load_checkpoint(tmp, 1, map_location=device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with torch.no_grad():
        logits = torch.cat([fresh.step(b)[1] for b in test_fb[f]])
    got = fresh.run_epoch(test_fb[f], 1, False)
    m = max(1.0, logits.abs().max().item())
    limit = 2 * FOLD_CKPT_STEPS * 2.0 ** -8 * m / 4
    gap = float(np.abs(got[2] - te[f][2]).max())
    log(f"lockstep checkpoint (fold {f}) in a fresh FoldTrainer: test scores"
        f" max |diff| {gap:.3e} (limit 2^-7 x {m:.3f} = {limit:.3e}), "
        f"loss {got[0]:.6g} vs {te[f][0]:.6g}")
    if not gap <= limit or got[3] != te[f][3]:
        raise AssertionError(f"lockstep checkpoint: scores {gap:.3e}")
    del fresh

    # one lockstep step (each fold's largest micro-batch) and its AdamW
    # application, traced
    last = [[b[-1]] for b in train_fb]

    def step():
        par.run_lockstep_epoch(last, 2, True, rng_seed=tc.seed)

    prof = trace_runs(step, 3, 8, what="lockstep step",
                      buckets=[(b[0]["ct"].shape[1], b[0]["pet"].shape[1])
                               for b in last])
    log(f"lockstep step (buckets {prof['buckets']}, B={bsz}, with its AdamW "
        f"application) traced: wall {prof['wall_ms']:.3f} ms, device "
        f"{prof['device_ms']:.3f} ms, idle share {prof['idle_share']:.3f}; "
        "top " + "; ".join(f"{r['name'][:60]} {r['ms']:.3f} ms "
                           f"({r['calls']:.0f}x)" for r in prof["top"]))
    del par
    torch.cuda.empty_cache()
    return {"folds": n_folds, "steps": steps,
            "step_ms": lock_s * 1e3 / steps, "stack_ms": stack_ms,
            "epoch_ms": lock_s * 1e3, "sequential_ms": seq_s * 1e3,
            "ratio": ratio, "peak_gib": peak / 2 ** 30,
            "sequential_peak_gib": seq_peak / 2 ** 30, "losses": losses,
            "checkpoint_gap": gap, "checkpoint_limit": limit,
            "profile": {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "idle_share")}}


def _lockstep_equality(torch, T, FP, ds, cfg, dim, device):
    """Phase 23 (b): two folds in lockstep under `parity` with dropout on,
    at the sequential batches' shapes, against two sequential trainers."""
    rng = np.random.default_rng(SEED + 24)
    folds = [(_fold_items(ds, rng, n, dim, FOLD_EQ["ct"], FOLD_EQ["pet"],
                          f"Q{f}T"),
              _fold_items(ds, rng, FOLD_EQ["test"], dim, FOLD_EQ["ct"],
                          FOLD_EQ["pet"], f"Q{f}E"))
             for f, n in enumerate(FOLD_EQ["train"])]
    tc = T.TrainerConfig(precision="parity", device=device)
    train_fb = [list(ds.batch_items(tr, tc.batch_size)) for tr, _ in folds]
    test_fb = [list(ds.batch_items(te, tc.batch_size)) for _, te in folds]
    par = FP.ParallelFoldTrainer(cfg, tc, len(folds))
    par.init_stacked()
    got = [par.run_lockstep_epoch(fb, 0, train, rng_seed=tc.seed)
           for fb, train in ((train_fb, True), (test_fb, False))]
    worst = {"loss": 0.0, "scores": 0.0, "params": 0.0, "key_bias": 0.0}
    bound = FOLD_KEY_BIAS_STEPS * T.cosine_lr(0, par.lr0, par.num_epochs)
    for f in range(len(folds)):
        t = T.FoldTrainer(cfg, tc)
        t.init_params()
        ref = [t.run_epoch(fb[f], 0, train, rng_seed=tc.seed)
               for fb, train in ((train_fb, True), (test_fb, False))]
        for r, g in zip(ref, got):
            worst["loss"] = max(worst["loss"], abs(g[f][0] - r[0]) / abs(r[0]))
            over = np.abs(g[f][2] - r[2]) - FOLD_SEQ_RTOL * np.abs(r[2])
            worst["scores"] = max(worst["scores"], float(over.max()))
            if g[f][3] != r[3] or not np.array_equal(g[f][1], r[1]):
                raise AssertionError(f"lockstep equality: fold {f} order")
        mine = par.fold_state(f)["params"]
        for k, v in t.model.state_dict().items():
            over = (mine[k] - v).abs() - FOLD_SEQ_RTOL * v.abs()
            if k.endswith("in_proj_bias"):
                q, kk, vv = over.split(v.shape[0] // 3)
                over = torch.cat([q, vv])
                worst["key_bias"] = max(worst["key_bias"], float(
                    (mine[k] - v).abs().split(v.shape[0] // 3)[1].max()))
            worst["params"] = max(worst["params"], float(over.max()))
        del t
    log(f"lockstep parity, dropout on, {len(folds)} folds x "
        f"{[len(b) for b in train_fb]} micro-batches against sequential "
        f"FoldTrainers: loss rel {worst['loss']:.3e} (limit "
        f"{FOLD_SEQ_REL:g}), scores and parameters past rtol "
        f"{FOLD_SEQ_RTOL:g} by {worst['scores']:.3e} and "
        f"{worst['params']:.3e} (limit {FOLD_SEQ_ATOL:g}), in_proj_bias key "
        f"third {worst['key_bias']:.3e} (limit {bound:.3e})")
    if not (worst["loss"] <= FOLD_SEQ_REL
            and worst["scores"] <= FOLD_SEQ_ATOL
            and worst["params"] <= FOLD_SEQ_ATOL
            and worst["key_bias"] <= bound):
        raise AssertionError(f"lockstep equality: {worst}")
    del par
    torch.cuda.empty_cache()
    return worst


def _whole_volume(torch, T, ds, trace_runs, cfg, dim, device):
    """Phase 23 (c): one train and one test epoch on whole volumes at B=4,
    buckets past 4096, nothing truncated; an 8192-bucket micro-batch
    traced; a `parity` B=1 step on an 8192-token item against the CPU's."""
    import warnings

    rng = np.random.default_rng(SEED + 25)
    train = _fold_items(ds, rng, WV_ITEMS["train"], dim, WV_ITEMS["ct"],
                        WV_ITEMS["pet"], "W")
    test = _fold_items(ds, rng, WV_ITEMS["test"], dim, WV_ITEMS["ct"],
                       WV_ITEMS["pet"], "V")
    tc = T.TrainerConfig(whole_volume=True, batch_size=WV_ITEMS["batch"],
                         device=device)
    trainer = T.FoldTrainer(cfg, tc)
    trainer.init_params()
    train, test = T._bucket_sorted(train), T._bucket_sorted(test)
    buckets = ds.token_buckets_for(train + test)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        train_b = list(ds.batch_items(train, tc.batch_size, buckets=buckets))
        test_b = list(ds.batch_items(test, tc.batch_size, buckets=buckets))
    for items, batches in ((train, train_b), (test, test_b)):
        sums = [int(x) for b in batches for x in b["ct_mask"].sum(1)]
        psums = [int(x) for b in batches for x in b["pet_mask"].sum(1)]
        if sums != [it.tokens_ct.shape[0] for it in items] or psums != [
                it.tokens_pet.shape[0] for it in items]:
            raise AssertionError("whole volume: tokens truncated")
    shapes = [(b["ct"].shape[1], b["pet"].shape[1]) for b in train_b + test_b]
    log(f"whole volume {tc.precision}: {len(train)} train and {len(test)} "
        f"test items, B={tc.batch_size}, buckets {buckets}, (CT, PET) "
        f"shapes {shapes}, longest CT item "
        f"{max(it.tokens_ct.shape[0] for it in train + test)} tokens")
    if max(s[0] for s in shapes) <= 4096:
        raise AssertionError("whole volume: no bucket past 4096")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = trainer.run_epoch(train_b, 0, True, rng_seed=tc.seed)
    train_s = time.perf_counter() - t0
    te = trainer.run_epoch(test_b, 0, False)
    peak = torch.cuda.max_memory_allocated()
    log(f"whole volume epoch (host clock): train {train_s * 1e3:.1f} ms, "
        f"{train_s * 1e3 / len(train_b):.3f} ms a micro-batch, loss "
        f"{tr[0]:.6g}; test loss {te[0]:.6g}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    if not (np.isfinite(tr[0]) and np.isfinite(te[0])
            and np.isfinite(te[2]).all()):
        raise AssertionError("whole volume: non-finite")

    big = max(train_b, key=lambda b: b["ct"].shape[1])
    gen = torch.Generator(device=device).manual_seed(SEED)
    accum = min(-(-trainer.virtual_batch // tc.batch_size), len(train_b))

    def micro_step():
        with trainer.policy.backends():
            trainer.step(big, 1.0 / (accum * tc.batch_size), True, gen)

    prof = trace_runs(micro_step, 3, 8, what="whole-volume micro-batch",
                      buckets=(big["ct"].shape[1], big["pet"].shape[1]))
    trainer.optimizer.zero_grad(set_to_none=True)
    log(f"whole-volume micro-batch (CT {prof['buckets'][0]}, PET "
        f"{prof['buckets'][1]}, B={tc.batch_size}) traced: wall "
        f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms, idle "
        f"share {prof['idle_share']:.3f}; top " + "; ".join(
            f"{r['name'][:60]} {r['ms']:.3f} ms ({r['calls']:.0f}x)"
            for r in prof["top"]))

    # `parity`, B=1, the longest CT item: the card against the CPU
    state = {k: v.detach().cpu() for k, v in
             trainer.model.state_dict().items()}
    item = max(train + test, key=lambda it: it.tokens_ct.shape[0])
    one = next(ds.batch_items([item], 1, buckets=buckets))
    del trainer
    torch.cuda.empty_cache()
    loss_c, g_c = _parity_grads(torch, T, cfg, state, one, device)
    t0 = time.perf_counter()
    loss_h, g_h = _parity_grads(torch, T, cfg, state, one, "cpu")
    cpu_s = time.perf_counter() - t0
    worst, worst_name = abs(loss_c - loss_h) / abs(loss_h), "loss"
    for k, ref in g_h.items():
        scale = ref.abs().max().item()
        err = (g_c[k] - ref).abs().max().item()
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else
                                               float("inf"))
        if ratio > worst:
            worst, worst_name = ratio, k
    log(f"whole-volume parity step (CT {one['ct'].shape[1]}, PET "
        f"{one['pet'].shape[1]}, B=1), card vs CPU ({cpu_s:.1f} s): loss "
        f"{loss_c:.8g} vs {loss_h:.8g}; worst |diff| / leaf max |grad| "
        f"{worst:.3e} ({worst_name}), limit {CLS_PARITY_REL:g}")
    if not worst <= CLS_PARITY_REL:
        raise AssertionError(f"whole-volume parity: {worst_name} at "
                             f"{worst:.3e}")
    torch.cuda.empty_cache()
    return {"micro_batches": len(train_b), "step_ms": train_s * 1e3 /
            len(train_b), "peak_gib": peak / 2 ** 30,
            "losses": [tr[0], te[0]], "buckets": list(buckets),
            "profile": {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "idle_share")},
            "parity_worst": worst}


def foldpar_phase(torch, A, device: str = "cuda") -> dict:
    """Phase 23: whole-volume and fold-parallel classifier training on one
    card at the published transformer config: (a) the 5 folds in lockstep
    (``ParallelFoldTrainer``) against the same folds one by one, a fold's
    checkpoint round trip and a traced lockstep step, (b) the lockstep's
    `parity` trajectory with dropout on against sequential trainers, (c)
    whole volumes past the 4096 bucket. No kernel of K1-K8 runs."""
    from vit_deep_radiomics_tpu_torch.data import datasets as ds
    from vit_deep_radiomics_tpu_torch.engine import checkpoint as ck
    from vit_deep_radiomics_tpu_torch.engine import foldpar as FP
    from vit_deep_radiomics_tpu_torch.engine import train as T
    from vit_deep_radiomics_tpu_torch.utils.profiling import trace_runs

    cfg = CLASSIFIER_CFG
    dim = cfg["models"]["transformer"]["feature_dim"]
    A.reset_launch_counts()
    out, seconds = {}, {}
    for name, part in (
            ("lockstep", lambda: _lockstep(torch, T, FP, ds, ck, trace_runs,
                                           cfg, dim, device)),
            ("equality", lambda: _lockstep_equality(torch, T, FP, ds, cfg,
                                                    dim, device)),
            ("whole_volume", lambda: _whole_volume(torch, T, ds, trace_runs,
                                                   cfg, dim, device))):
        t0 = time.perf_counter()
        out[name] = part()
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"phase 23 seconds: {json.dumps(seconds)}")
    counts = dict(A.LAUNCHES)
    if any(counts.values()):
        raise AssertionError(f"phase 23 launched kernels: {counts}")
    return out


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
    for src, n_tiled in TILED_SOURCES.items():
        funcs = cuda_build.ptxas_functions(build_logs[src])
        tiled = {f: r for f, r in funcs.items() if "tiled_kernel" in f}
        log(f"ptxas {src} (tiled fp32 forward): " + " | ".join(
            f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
            for f, r in tiled.items()) + f"; the whole source "
            f"{cuda_build.spill_bytes(build_logs[src])} bytes spill")
        if build_logs[src] and (len(tiled) != n_tiled or any(
                r["spill"] for r in tiled.values())):
            raise AssertionError(f"{src}: the tiled fp32 forward's kernels "
                                 f"{tiled} spill or are missing")
    # K3's loops: the head dims each dtype keeps (mangled: ILi<D>E)
    funcs = cuda_build.ptxas_functions(build_logs["flash_attention"])
    for kern, dims in K3_LOOP_INSTANCES.items():
        found = {f: r for f, r in funcs.items() if kern in f}
        log(f"ptxas flash_attention ({kern}): " + " | ".join(
            f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
            for f, r in found.items()))
        built = sorted(int(m.group(1)) for f in found
                       for m in [re.search(r"ILi(\d+)E", f)] if m)
        if build_logs["flash_attention"] and built != list(dims):
            raise AssertionError(f"flash_attention: {kern} built for D "
                                 f"{built}, not {list(dims)}")
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
    # K3's window mode on K1's whole-window body: its instances (N 64, 208,
    # 224 and 256 keys) must show no spill and no wgmma serialisation
    blog = build_logs["flash_attention"]
    windowed = {f: r for f, r in cuda_build.ptxas_functions(blog).items()
                if "window_kernel" in f}
    serial = [ln.strip() for ln in blog.splitlines() if "C75" in ln]
    log("ptxas flash_attention (whole-window body): " + " | ".join(
        f"{f}: {r['registers']} registers, {r['spill']} bytes spill"
        for f, r in windowed.items()) + f"; C75xx lines: {len(serial)}")
    if blog and (len(windowed) != K3_WINDOW_INSTANCES or serial or any(
            r["spill"] for r in windowed.values())):
        raise AssertionError(f"flash_attention: the whole-window kernels "
                             f"{windowed} spill, are missing or are "
                             f"serialised: {serial}")
    for src, n_hopper in HOPPER_SOURCES.items():
        blog = build_logs[src]
        hopper = {f: r for f, r in cuda_build.ptxas_functions(blog).items()
                  if "hopper_kernel" in f}
        serial = [ln.strip() for ln in blog.splitlines() if "C75" in ln]
        secs = dict(cuda_build.BUILDS).get(src)
        took = f"nvcc {secs:.2f} s" if secs else "built earlier"
        log(f"ptxas {src} (Hopper, {len(hopper)} instances, {took}): " +
            " | ".join(
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

    # the K6 bf16 forward (its dq and dkv sit in NO_SPILL's sources) and
    # K7's fp32 C 1536 loop instance keep their accumulators in registers
    for src, key, want in (("flash_attention_fwd", "mma_fwd_kernel", None),
                           ("fused_ln_mlp_residual", "mlp_f32_kernel",
                            "1536")):
        funcs = {f: r for f, r in cuda_build.ptxas_functions(
            build_logs[src]).items() if key in f and (want or "") in f}
        log(f"ptxas {src} ({key}{' ' + want if want else ''}): " +
            " | ".join(f"{f}: {r['registers']} registers, {r['spill']} "
                       f"bytes spill" for f, r in funcs.items()))
        if build_logs[src] and (len(funcs) != 1 or any(
                r["spill"] for r in funcs.values())):
            raise AssertionError(f"{src}: {key} {funcs} spills or is "
                                 "missing")

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
    k6_bf16_records = k6_phase(torch, G, peaks, "bfloat16")
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
    records["fused_ln_mlp_residual_f32_c1536"] = k7_f32_wide_phase(torch,
                                                                   peaks)
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
    torch.cuda.empty_cache()
    sam2048 = sam2048_phase(torch, A, G, ft, vit)              # phase 20
    for kname in K5_NAMES:
        records[kname]["launches_sam2048_fast"] = sam2048[kname]
    torch.cuda.empty_cache()
    log("classifier training: " + json.dumps(
        classifier_phase(torch, A)))                           # phase 21
    torch.cuda.empty_cache()
    serving = serving_phase(torch, A)                          # phase 22
    log("serving: " + json.dumps(serving))
    for kname in ("fused_window_attention", "fused_global_attention"):
        records[kname]["launches_serve_dense"] = \
            serving["dense"]["launches"][kname]
        records[kname]["launches_serve_pipeline"] = \
            serving["pipeline"]["launches"][kname]
    records["fused_ln_mlp_residual"]["launches_serve_fused_mlp"] = \
        serving["routing"]["launches"]["fused_ln_mlp_residual"]
    for kname, shapes in serving["kernels"].items():
        records[kname]["serve_shapes"] = shapes
    torch.cuda.empty_cache()
    log("fold-parallel and whole-volume training: " + json.dumps(
        foldpar_phase(torch, A)))                              # phase 23
    torch.cuda.empty_cache()
    sam768_counts, sam768 = sam768_phase(torch, A, ft, vit)  # phase 24
    log("fine-tune SAM @768 fast: " + json.dumps(sam768))
    torch.cuda.empty_cache()
    sam640_counts, sam640 = sam640_phase(torch, A, ft, vit)  # phase 25
    log("fine-tune SAM @640 fast: " + json.dumps(sam640))
    torch.cuda.empty_cache()
    sam896_counts, sam896 = sam896_phase(torch, A, ft, vit)  # phase 26
    log("fine-tune SAM @896 fast: " + json.dumps(sam896))
    torch.cuda.empty_cache()
    sam576_counts, sam576 = sam576_phase(torch, A, ft, vit)  # phase 27
    log("fine-tune SAM @576 fast: " + json.dumps(sam576))
    torch.cuda.empty_cache()
    sam544_counts = sam544_phase(torch, A, ft, vit)            # phase 28
    # K6 in bf16: the @768 `fast` steps are the main path of the Hopper
    # bodies (also @640, @896 and @576), the @544 ones of the mma.sync
    # bodies
    for kname, rec in k6_bf16_records.items():
        at544 = kname.endswith("_bf16")
        rec["launches"] = (sam544_counts if at544 else sam768_counts)[kname]
        if not at544:
            rec["fast768_step"] = sam768
            rec["launches_sam640_fast"] = sam640_counts[kname]
            rec["launches_sam896_fast"] = sam896_counts[kname]
            rec["launches_sam576_fast"] = sam576_counts[kname]
            rec["fast640_step"] = sam640
            rec["fast896_step"] = sam896
            rec["fast576_step"] = sam576
    records.update(k6_bf16_records)
    log(card_line())
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
