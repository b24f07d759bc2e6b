"""Port vs JAX: K7, the fused LayerNorm → MLP → residual, and the
``VDR_FUSED_MLP=1`` block path.

The same numpy inputs go through the JAX ``fused_ln_mlp_residual`` (Pallas
in interpret mode on the CPU) and the port's function on CPU tensors (K7's
plain version), with and without a layerscale and with a row count that is
not a multiple of JAX's 512-row tile. fp32 agrees to 5e-6; bf16 to one bf16
step, |got − want| ≤ 2^-7·|want| elementwise (the two sides take the
LayerNorm statistics and the sums in other orders, so a rounding of y, g
or the branch output may fall on the other side). On the CPU a ``fast``
model with ``VDR_FUSED_MLP=1`` equals the unfused model bit for bit, since
the plain version is the unfused modules' computation.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_deep_radiomics_tpu.ops.mlp_fused import (
    fused_ln_mlp_residual as jax_fused,
)
from vit_deep_radiomics_tpu_torch.core.precision import (
    FAST, INFERENCE, INT8, PARITY,
)
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M


def _inputs(rng, rows, c, hidden, with_ls):
    x = rng.normal(size=(rows, c)).astype(np.float32)
    ln_s = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=c)).astype(np.float32)
    w1 = (rng.normal(size=(c, hidden)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.02 * rng.normal(size=hidden)).astype(np.float32)
    w2 = (rng.normal(size=(hidden, c)) / np.sqrt(hidden)).astype(np.float32)
    b2 = (0.02 * rng.normal(size=c)).astype(np.float32)
    ls = (0.1 + 0.02 * rng.normal(size=c)).astype(np.float32) \
        if with_ls else None
    return x, ln_s, ln_b, w1, b1, w2, b2, ls


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(rng, dtype, with_ls):
    x, *rest = _inputs(rng, 2 * 37, 128, 512, with_ls)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_fused(jnp.asarray(x).astype(jdt),
                     *(None if a is None else jnp.asarray(a) for a in rest),
                     eps=1e-6, chunk=256)
    got = M.fused_ln_mlp_residual(
        torch.from_numpy(x).to(tdt),
        *(None if a is None else torch.from_numpy(a) for a in rest),
        eps=1e-6)
    assert got.dtype == tdt and got.shape == x.shape
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=5e-6)
    else:
        gap = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
        assert gap.max() <= 0.0, gap.max()


@pytest.mark.parametrize("with_ls", [False, True])
def test_plain_matches_jax_at_the_path_width(rng, with_ls):
    """bf16 at the Hopper body's width (C 768, hidden 3072: SAM ViT-B/16,
    DINOv2 ViT-B/14), 70 rows: one bf16 step plus 1e-2, the card tests'
    bf16 K7 limit. At this width a flip of the rounded branch output moves
    the rounded residual sum by a further step of |x + o| (up to 5 here):
    measured at most 7.6e-3 beyond one step over three seeds, with fewer
    than 0.1% of the elements past one step."""
    x, *rest = _inputs(rng, 70, 768, 3072, with_ls)
    want = jax_fused(jnp.asarray(x).astype(jnp.bfloat16),
                     *(None if a is None else jnp.asarray(a) for a in rest),
                     eps=1e-6, chunk=512)
    got = M.fused_ln_mlp_residual(
        torch.from_numpy(x).bfloat16(),
        *(None if a is None else torch.from_numpy(a) for a in rest),
        eps=1e-6)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    gap = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
    assert gap.max() <= 1e-2, gap.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_at_vitg_width(rng, dtype):
    """DINOv2 ViT-g/14's width (C 1536, hidden 6144), 40 rows, with the
    layerscale: fp32 to 5e-6 and bf16 to one bf16 step plus 1e-2, the
    limits of the widths above."""
    x, *rest = _inputs(rng, 40, 1536, 6144, True)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_fused(jnp.asarray(x).astype(jdt),
                     *(jnp.asarray(a) for a in rest), eps=1e-6, chunk=512)
    got = M.fused_ln_mlp_residual(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        *(torch.from_numpy(a) for a in rest), eps=1e-6)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=5e-6)
    else:
        gap = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
        assert gap.max() <= 1e-2, gap.max()


def test_route_is_plain_on_cpu(rng):
    t = [None if a is None else torch.from_numpy(a)
         for a in _inputs(rng, 8, 64, 256, True)]
    assert M.fused_ln_mlp_residual_route(*t) == "plain"
    assert M.fused_ln_mlp_residual_route(t[0].bfloat16(), *t[1:]) == "plain"


def test_leading_shape_and_cpu_launch_count(rng):
    x, *rest = _inputs(rng, 30, 64, 256, True)
    t = [None if a is None else torch.from_numpy(a) for a in rest]
    A.reset_launch_counts()
    got = M.fused_ln_mlp_residual(torch.from_numpy(x).reshape(2, 3, 5, 64),
                                  *t)
    want = M.fused_ln_mlp_residual(torch.from_numpy(x), *t)
    assert got.shape == (2, 3, 5, 64)
    assert torch.equal(got.reshape(30, 64), want)
    assert A.LAUNCHES == dict.fromkeys(A.LAUNCHES, 0)


@pytest.mark.parametrize("case", ["w1", "b2", "layerscale"])
def test_shape_errors(rng, case):
    x, ln_s, ln_b, w1, b1, w2, b2, ls = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs(rng, 8, 64, 256, True))
    if case == "w1":
        w1 = w1[:32]
    elif case == "b2":
        b2 = b2[:32]
    else:
        ls = ls[:10]
    with pytest.raises(ValueError, match=case):
        M.fused_ln_mlp_residual(x, ln_s, ln_b, w1, b1, w2, b2, ls)


def test_unbuilt_width_refused_before_launch():
    """A non-CPU tensor never takes the plain path: a width K7 does not
    build raises (meta tensors stand in for CUDA ones)."""
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    A.reset_launch_counts()
    with pytest.raises(ValueError, match="width 96"):
        M.fused_ln_mlp_residual(meta(4, 96).bfloat16(), meta(96), meta(96),
                                meta(96, 384), meta(384), meta(384, 96),
                                meta(96))
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 0


@pytest.mark.parametrize("c,hidden,dtype,err", [
    (96, 384, torch.bfloat16, "width 96"),
    (768, 3050, torch.bfloat16, "hidden width 3050"),
    (768, 3080, torch.float32, "hidden width 3080"),
    (768, 3072, torch.float16, "float32 or bfloat16"),
    (1536, 6148, torch.float32, "hidden width 6148"),
    (1280, 5120, torch.float32, "width 1280 in torch.float32"),
    (1536, 6152, torch.bfloat16, "hidden width 6152")])
@pytest.mark.parametrize("entry", ["route", "kernel"])
def test_refused_before_launch(c, hidden, dtype, err, entry):
    """What neither body takes is refused by the route and by the wrapper
    before any build or launch: a width without a build, a hidden width
    that is not a multiple of the loops' chunk (32 in bf16, 16 in fp32, 16
    in bf16 and 8 in fp32 at C 1536; the Hopper body's 128 and the cluster
    body's 256 are the route's to decide), or another dtype (meta tensors
    stand in for CUDA ones)."""
    def meta(*shape, dt=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dt)

    args = (meta(4, c, dt=dtype), meta(c), meta(c), meta(c, hidden),
            meta(hidden), meta(hidden, c), meta(c))
    fn = M.fused_ln_mlp_residual_route if entry == "route" \
        else M.fused_ln_mlp_residual
    A.reset_launch_counts()
    with pytest.raises((ValueError, TypeError), match=err):
        fn(*args)
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 0


class _Built(Exception):
    """Raised in place of a kernel build: every check before it passed."""


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden", [6144, 6160])
@pytest.mark.parametrize("entry", ["route", "kernel"])
def test_vitg_width_admitted(entry, hidden, dtype, monkeypatch):
    """C 1536 with ViT-g/14's hidden 6144 (bf16: the cluster body's) or an
    odd multiple of 16 (bf16: the loops'), in bf16 or fp32 (the loops'
    16-row, 8-unit instance), passes every check of the route and of the
    wrapper and goes on to the build (the card tests hold every body); meta
    tensors stand in for CUDA ones and the build is replaced by a
    marker."""
    def built(*args, **kwargs):
        raise _Built()

    monkeypatch.setattr(M, "_load", built)

    def meta(*shape, dt=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dt)

    c = 1536
    args = (meta(4, c, dt=dtype), meta(c), meta(c),
            meta(c, hidden), meta(hidden), meta(hidden, c), meta(c), meta(c))
    fn = M.fused_ln_mlp_residual_route if entry == "route" \
        else M.fused_ln_mlp_residual
    A.reset_launch_counts()
    with pytest.raises(_Built):
        fn(*args)
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 0


@pytest.mark.parametrize("code,body", [(0, "loops"), (1, "hopper"),
                                       (2, "cluster")])
def test_route_names_the_c_entrys_body(code, body, monkeypatch):
    """On a non-CPU tensor the route reports the body the C entry
    (vdr_fused_ln_mlp_residual_route) names by its code, asked with the
    width, the hidden width and the dtype's code; the entry is replaced by
    a stand-in (meta tensors stand in for CUDA ones)."""
    asked = []

    def entry(*a):
        asked.append(a)
        return code

    monkeypatch.setattr(M, "_load", lambda *a, **k: (None, entry))

    def meta(*shape, dt=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dt)

    c, hidden = 1536, 6144
    args = (meta(4, c, dt=torch.bfloat16), meta(c), meta(c),
            meta(c, hidden), meta(hidden), meta(hidden, c), meta(c))
    assert M.fused_ln_mlp_residual_route(*args) == body
    assert asked == [(c, hidden, 1)]


SAM_TINY = dict(image_size=64, patch_size=8, width=128, depth=3, num_heads=2,
                window_size=4, global_indexes=(1,), neck_channels=32)
DINO_TINY = dict(image_size=56, width=128, depth=2, num_heads=2)


def _model(cfg, policy, seed=0):
    return tvit.ViTDense(cfg, policy=policy).init_random(seed).eval()


@pytest.mark.parametrize("family", ["sam", "dinov2"])
@pytest.mark.parametrize("policy", [FAST, INFERENCE], ids=["fast",
                                                           "inference"])
def test_block_fused_equals_unfused(monkeypatch, family, policy):
    """VDR_FUSED_MLP=1 on a frozen bf16 model: every block calls K7's
    wrapper (SAM, and DINOv2 with its ls2 layerscale) and the output equals
    the unfused path's bit for bit on the CPU."""
    cfg = dataclasses.replace(tvit.SAM_VIT_B, **SAM_TINY) if family == "sam" \
        else dataclasses.replace(tvit.DINOV2_CONFIGS["dinov2_vitb14"],
                                 **DINO_TINY)
    model = _model(cfg, policy)
    img = torch.rand(2, cfg.image_size, cfg.image_size, 3,
                     generator=torch.Generator().manual_seed(1))
    calls = []
    real = tvit.fused_ln_mlp_residual
    monkeypatch.setattr(tvit, "fused_ln_mlp_residual",
                        lambda *a, **k: calls.append(a[7]) or real(*a, **k))
    with torch.no_grad():
        monkeypatch.delenv("VDR_FUSED_MLP", raising=False)
        want = model(img)
        assert not calls
        monkeypatch.setenv("VDR_FUSED_MLP", "1")
        got = model(img)
    assert len(calls) == cfg.depth
    assert all((ls is not None) == (family == "dinov2") for ls in calls)
    assert torch.equal(got, want)


@pytest.mark.parametrize("policy,trainable,use_flash", [
    (PARITY, False, True), (INT8, False, True), (FAST, True, True),
    (FAST, False, False)], ids=["parity", "int8", "trainable", "no_flash"])
def test_gate_refuses_other_paths(monkeypatch, policy, trainable, use_flash):
    """JAX's gate (vit.py:914-919): only a frozen, flash, bf16,
    non-quantized block takes K7, even with VDR_FUSED_MLP=1."""
    cfg = dataclasses.replace(tvit.SAM_VIT_B, **SAM_TINY)
    model = tvit.ViTDense(cfg, policy=policy, trainable=trainable,
                          use_flash=use_flash)
    monkeypatch.setenv("VDR_FUSED_MLP", "1")
    assert not any(blk._fused_mlp_on(policy) for blk in model.blocks)
    assert all(blk._fused_mlp_on(FAST) for blk in tvit.ViTDense(
        cfg, policy=FAST).blocks)
