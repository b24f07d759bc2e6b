"""Dense-descriptor ViT backbone: SAM/MedSAM ViT-B/16 and DINOv2, in PyTorch.

Counterpart of ``vit_deep_radiomics_tpu/models/vit.py``. Activations stay
NHWC as in JAX; parameters use the reference PyTorch names (SAM:
``patch_embed.proj.weight``, ``blocks.{i}.attn.qkv.weight``,
``blocks.{i}.attn.rel_pos_h``, ``blocks.{i}.mlp.lin1.weight``,
``neck.0.weight`` …; DINOv2 as torch.hub names it: ``cls_token``,
``pos_embed``, ``blocks.{i}.ls1.gamma``, ``blocks.{i}.mlp.fc1.weight``,
``norm.weight`` …), so reference state dicts load with ``load_state_dict``
and ``models/convert.py::params_from_jax`` bridges the Flax param tree.

Attention runs the fused CUDA kernels of ``ops/attention.py``: SAM's 14×14
windowed layers through K1, its 64×64 global layers through K2, and
DINOv2's bias-free layers through K2 with the tokens padded (1370 → 1536)
and masked by ``kv_len``, selected by :meth:`WindowedAttention.
_fused_variant` exactly as in JAX (a rel-pos grid of ≤1024 tokens takes
window mode even in a global layer). Grids and head layouts the fused
kernels refuse (a rel-pos grid over 1024 tokens that no tile divides, e.g.
SAM's 48×48 global grid at 768 px; a head dim that does not tile 128 lanes)
take the generic path, K3 (``flash_attention``) over the key grid padded
as JAX pads it (:meth:`WindowedAttention._flash`). ``use_flash=False`` is
the plain oracle path of the tests.

Under the ``int8`` policy the five per-block matmuls of frozen layers run
s8×s8→s32 through K8 (``ops/quant.py``); with ``VDR_FUSED_MLP=1`` a frozen
bf16 block's LayerNorm → MLP → residual is one K7 call
(``ops/mlp_fused.py``). Under a bf16 ``param_dtype`` (``inference``,
``int8``) the modules hold bf16 parameters.

``trainable=True`` (fine-tuning) routes attention as JAX does (vit.py:
307-318). Under ``fast`` (bf16) the fused autograd Functions of
``ops/attention_grad.py``: window mode forward K1 and backward K4, global
and nobias mode K5 (forward with the lse residual, dq and dkv kernels).
Under ``parity`` (fp32) the generic path: the packed qkv projection,
per-head q/k/v, fp32 bias einsums, and K6 (``flash_attention_trainable``)
over whole key grids with a bias or over padded tokens with ``kv_len``.
``remat`` recomputes whole blocks or only the MLP in the backward
(``torch.utils.checkpoint``).

Numerics follow the JAX policy rules: matmuls in the compute dtype with
the fp32 accumulator kept and the bias added to it in fp32 before the one
cast down (:func:`_policy_dot`),
LayerNorm statistics in fp32, tanh GELU under bf16 and erf GELU under fp32,
the rel-pos bias computed from the unscaled q in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.precision import FAST, Policy, cast_params
from ..ops.attention import _head_group, attention_reference, \
    flash_attention, flash_attention_fused_qkv
from ..ops.attention_grad import flash_attention_trainable, \
    global_attention_trainable, window_attention_trainable
from ..ops.mlp_fused import fused_ln_mlp_residual
from ..ops.quant import int8_dot, int8_dot_prequant, quantize_rows

__all__ = ["ViTDenseConfig", "ViTDense", "SAM_VIT_B", "DINOV2_CONFIGS",
           "window_partition", "window_unpartition", "resize_bicubic"]


class _MatmulF32(torch.autograd.Function):
    """``x @ w.T`` for bf16 operands, returning the fp32 accumulator
    unrounded (JAX's ``preferred_element_type=float32``): on the card one
    cuBLAS bf16 product with an fp32 output, on the CPU the fp32 product of
    the bf16 values (exact products, fp32 sums). The backward is the bf16
    products of the rounded-down gradient, as a bf16 matmul's own.

    A 3-D ``w`` (G, out, in) is a stack of weights, one per group of a
    ``x`` (G, ..., in): one batched product (``torch.bmm`` with an fp32
    output on the card). That is the batching rule ``torch.func.vmap``
    takes for this function (the fold-parallel trainer's stacked
    classifiers); its gradients are taken inside the ``vmap``, so the
    backward sees one weight."""

    @staticmethod
    def forward(x, w):
        if w.dim() == 3:
            x3 = x.reshape(x.shape[0], -1, x.shape[-1])
            wt = w.transpose(1, 2)
            if x.device.type == "cpu":
                out = x3.float() @ wt.float()
            else:
                out = torch.bmm(x3, wt, out_dtype=torch.float32)
            return out.reshape(*x.shape[:-1], w.shape[1])
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type == "cpu":
            out = x2.float() @ w.float().t()
        else:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return gx, gw

    @staticmethod
    def vmap(info, in_dims, x, w):
        xd, wd = in_dims
        x = x.movedim(xd, 0) if xd is not None else \
            x.expand(info.batch_size, *x.shape)
        if wd is None:
            return _MatmulF32.apply(x, w), 0
        return _MatmulF32.apply(x, w.movedim(wd, 0)), 0


def _policy_dot(x, weight, bias, dtype, quant: bool = False, x_q=None):
    """``x @ weight.T + bias`` (torch Linear layout), fp32 out; the caller
    casts down (JAX vit.py::_policy_dot). The product keeps its fp32
    accumulator and the bias is added to it in fp32. ``quant`` takes the
    dynamic-int8 product (``ops/quant.py``, K8 on the card), ``x_q`` a
    pre-quantized ``(int8, scale)`` pair of x shared by several matmuls."""
    if quant:
        out = int8_dot(x, weight.t()) if x_q is None \
            else int8_dot_prequant(x_q, weight.t())
    elif dtype == torch.float32:
        out = torch.matmul(x.float(), weight.float().t())
    else:
        out = _MatmulF32.apply(x.to(dtype), weight.to(dtype))
    return out + bias.float() if bias is not None else out


@dataclasses.dataclass(frozen=True)
class ViTDenseConfig:
    """Static architecture config for a dense-descriptor ViT."""

    name: str
    image_size: int
    patch_size: int
    width: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    window_size: int = 0               # 0 = all-global attention
    global_indexes: Sequence[int] = ()
    use_rel_pos: bool = False          # SAM decomposed relative positions
    neck_channels: int = 0             # SAM conv neck output dim (0 = none)
    use_cls_token: bool = False        # DINOv2
    layerscale_init: float = 0.0       # DINOv2 LayerScale (0 = disabled)
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @property
    def feature_dim(self) -> int:
        return self.neck_channels or self.width


# MedSAM image encoder: SAM ViT-B/16 @1024 with the 256-channel neck.
SAM_VIT_B = ViTDenseConfig(
    name="sam_vit_b",
    image_size=1024,
    patch_size=16,
    width=768,
    depth=12,
    num_heads=12,
    mlp_ratio=4.0,
    window_size=14,
    global_indexes=(2, 5, 8, 11),
    use_rel_pos=True,
    neck_channels=256,
)


def _dinov2(name, width, depth, heads, image_size=518):
    return ViTDenseConfig(
        name=name, image_size=image_size, patch_size=14, width=width,
        depth=depth, num_heads=heads, use_cls_token=True,
        layerscale_init=1e-5,
    )


DINOV2_CONFIGS = {
    "dinov2_vits14": _dinov2("dinov2_vits14", 384, 12, 6),
    "dinov2_vitb14": _dinov2("dinov2_vitb14", 768, 12, 12),
    "dinov2_vitl14": _dinov2("dinov2_vitl14", 1024, 24, 16),
    "dinov2_vitg14": _dinov2("dinov2_vitg14", 1536, 40, 24),
}


def _q_blocking(s: int) -> tuple[int, int]:
    """(padded length, block) of a token axis, JAX vit.py:206: the TPU
    grid-step cost model padded² · (1 + 0.05 · steps) over blocks of 1024,
    512, 256 and 128 tokens. 196 → (256, 256); 1370 → (1536, 512); 2304 →
    (3072, 1024); 4096 → (4096, 512)."""
    best = None
    for blk in (1024, 512, 256, 128):
        padded = -(-s // blk) * blk
        score = padded * padded * (1 + 0.05 * (padded // blk) ** 2)
        if best is None or score < best[0]:
            best = (score, padded, blk)
    return best[1], best[2]


def _pick_block_k(sq_pad: int, cap: int) -> int:
    """Largest kv tile ≤ ``cap`` that divides ``sq_pad`` and is a multiple
    of 128 (JAX vit.py:189)."""
    for div in range(1, sq_pad // 128 + 1):
        if sq_pad % div == 0:
            bk = sq_pad // div
            if bk <= cap and bk % 128 == 0:
                return bk
    return 128


def _padded_tokens(s: int) -> int:
    """The length JAX pads a bias-free token axis to (:func:`_q_blocking`):
    1370 → 1536."""
    return _q_blocking(s)[0]


def _pad_to(x, size: int, dim: int):
    """Zero-pad ``dim`` of x at the end to ``size``."""
    extra = size - x.shape[dim]
    if not extra:
        return x
    pad = [0, 0] * (x.ndim - dim % x.ndim)
    pad[-1] = extra
    return F.pad(x, pad)


def _pad_tokens(tensors, s: int):
    """Pad the token axis (second to last) of each tensor from s to
    :func:`_padded_tokens`; returns the tensors and the (B,) ``kv_len``
    that masks the pads, None when nothing was padded."""
    pad = _padded_tokens(s) - s
    if not pad:
        return tensors, None
    kv_len = torch.full((tensors[0].shape[0],), s, dtype=torch.int32,
                        device=tensors[0].device)
    return [F.pad(t, (0, 0, 0, pad)) for t in tensors], kv_len


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5 (jax.image's ``bicubic``)."""
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size: int, out_size: int):
    """(out, in) fp32 weights of ``jax.image.resize(..., "bicubic")`` along
    one axis (jax ``compute_weight_mat``): half-pixel centres, the kernel
    widened by the scale when downsampling (antialias), weights divided by
    their sum, output samples outside the input zeroed. torch's bicubic
    ``interpolate`` (a = -0.75, clamped edges) computes another function."""
    inv = 1.0 / (out_size / in_size)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]
         ).abs() / max(inv, 1.0)
    w = _keys_cubic(x)                                      # (in, out)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t()


def resize_bicubic(x, out_h: int, out_w: int):
    """(B, H, W, C) → (B, out_h, out_w, C), ``jax.image.resize`` bicubic
    (an axis of equal size is left as it is, as JAX skips it)."""
    b, h, w, c = x.shape
    x = x.float()
    if out_h != h:
        x = torch.einsum("oi,bijc->bojc", _resize_weights(h, out_h).to(
            x.device), x)
    if out_w != w:
        x = torch.einsum("pj,bijc->bipc", _resize_weights(w, out_w).to(
            x.device), x)
    return x


class PatchEmbed(nn.Module):
    """Stride-p p×p patch embedding as reshape + matmul; the weight keeps
    the conv layout (width, 3, p, p) of the reference checkpoint and is
    flattened in (kh, kw, cin) order like the JAX kernel."""

    def __init__(self, cfg: ViTDenseConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, p, stride=p)

    def forward(self, x, policy: Policy):          # (B, H, W, 3)
        p = self.proj.kernel_size[0]
        b, hh, ww, cin = x.shape
        hp, wp = hh // p, ww // p
        x = x.reshape(b, hp, p, wp, p, cin).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hp, wp, p * p * cin)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * cin)
        out = _policy_dot(x, w, self.proj.bias, policy.compute_dtype)
        return out.to(policy.compute_dtype)         # (B, hp, wp, width)


def _rel_pos_table(rel_pos, q_size: int, k_size: int):
    """(q_size, k_size, D) table: entry [qi, ki] = rel_pos[qi - ki +
    k_size - 1] (SAM decomposed rel-pos, equal q/k sizes)."""
    qi = torch.arange(q_size, device=rel_pos.device)[:, None]
    ki = torch.arange(k_size, device=rel_pos.device)[None, :]
    return rel_pos[qi - ki + k_size - 1]


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, fp32 statistics regardless of policy."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class WindowedAttention(nn.Module):
    """Multi-head attention over a (B, H, W, C) token grid, with SAM's
    decomposed relative-position bias when the config has it."""

    def __init__(self, cfg: ViTDenseConfig, input_size: int,
                 use_flash: bool = True, trainable: bool = False,
                 window_group: int = 1):
        super().__init__()
        self.cfg = cfg
        self.use_flash = use_flash
        self.trainable = trainable
        # independent windows batched per K3 call (JAX ``window_group``)
        self.window_group = window_group
        c, hd = cfg.width, cfg.head_dim
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)
        if cfg.use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def _fused_variant(self, h: int, w: int) -> str | None:
        """Which fused kernel mode fits this token grid (JAX vit.py:420).

        ``window`` for rel-pos grids of ≤1024 tokens, ``global`` for
        larger rel-pos grids that divide into tile-friendly blocks,
        ``nobias`` without rel-pos, None when the head layout does not
        tile."""
        if _head_group(self.cfg.num_heads, self.cfg.head_dim) is None:
            return None
        s = h * w
        if self.cfg.use_rel_pos:
            if s <= 1024:
                return "window"
            if any(s % blk == 0 and blk % w == 0
                   for blk in (1024, 512, 256, 128)):
                return "global"
            return None
        return "nobias"

    def forward(self, x, policy: Policy):
        cfg = self.cfg
        b, h, w, c = x.shape
        dtype = policy.compute_dtype
        tokens = x.reshape(b, h * w, c).to(dtype)
        # dynamic-int8 projections on frozen layers only (round() has no
        # useful gradient): trainable layers keep the float matmuls
        quant = policy.quantized and not self.trainable
        variant = self._fused_variant(h, w)
        # JAX vit.py:307-318: trainable layers take the fused layout under
        # bf16 only; parity (fp32) training, and bf16 training on a grid no
        # fused kernel takes (SAM's global layers at 768 px), the generic
        # K6 path
        fused_trainable = (self.trainable and variant is not None
                           and dtype == torch.bfloat16)
        if self.use_flash and (fused_trainable if self.trainable
                               else variant is not None):
            out = self._fused(tokens, b, h, w, variant, dtype, quant)
        elif self.use_flash and self.trainable:
            out = self._generic_trainable(tokens, b, h, w, dtype)
        elif self.use_flash:
            q, k, v, bias_h, bias_w = self._heads(tokens, b, h, w, dtype,
                                                  quant)
            out = self._flash(q, k, v, bias_h, bias_w, h, w)
            out = out.transpose(1, 2).reshape(b, h * w, c)
        else:
            out = self._oracle(tokens, b, h, w, dtype, quant)
        out = _policy_dot(out, self.proj.weight, self.proj.bias, dtype,
                          quant)
        return out.to(dtype).reshape(b, h, w, c)

    def _fused(self, tokens, b, h, w, variant, dtype, quant=False):
        """Fused layout (JAX ``_fused_qkv``): split projection, per-head
        decomposed bias, K1 (window), K2 (global, nobias) or, trainable,
        K1/K4 and K5. nobias pads the tokens and masks them by kv_len."""
        c, nh = self.cfg.width, self.cfg.num_heads
        # split projection: q and kv as separate matmuls, as in JAX; under
        # int8 they share one quantization of the tokens
        wq, wkv = self.qkv.weight[:c], self.qkv.weight[c:]
        bq, bkv = self.qkv.bias[:c], self.qkv.bias[c:]
        tok_q = quantize_rows(tokens) if quant else None
        q = _policy_dot(tokens, wq, bq, dtype, quant, tok_q).to(dtype)
        kv = _policy_dot(tokens, wkv, bkv, dtype, quant, tok_q).to(dtype)
        if variant == "nobias":
            s = h * w
            (q, kv), kv_len = _pad_tokens((q, kv), s)
            if self.trainable:
                out = global_attention_trainable(q, kv, kv_len=kv_len,
                                                 num_heads=nh)
            else:
                out = flash_attention_fused_qkv(q, kv, kv_len=kv_len,
                                                num_heads=nh)
            return out[:, :s]
        bias_h, bias_w = self._bias_fused(q, b, h, w, dtype)
        window = variant == "window"
        if not self.trainable:
            return flash_attention_fused_qkv(
                q, kv, bias_h, bias_w, num_heads=nh,
                window_tokens=h * w if window else None)
        if window:
            return window_attention_trainable(
                q, kv, bias_h, bias_w, num_heads=nh, window_tokens=h * w)
        return global_attention_trainable(q, kv, bias_h, bias_w,
                                          num_heads=nh)

    def _bias_fused(self, q, b, h, w, dtype):
        """Per-head decomposed bias (B, H, S, h) and (B, H, S, w) from the
        unscaled q, computed in the compute dtype."""
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        rh = _rel_pos_table(self.rel_pos_h.to(dtype), h, h)   # (h, h, hd)
        rw = _rel_pos_table(self.rel_pos_w.to(dtype), w, w)
        qg = q.reshape(b, h, w, nh, hd)
        bias_h = torch.einsum("byxnd,ykd->bnyxk", qg, rh)
        bias_w = torch.einsum("byxnd,xkd->bnyxk", qg, rw)
        return (bias_h.reshape(b, nh, h * w, h).contiguous(),
                bias_w.reshape(b, nh, h * w, w).contiguous())

    def _heads(self, tokens, b, h, w, dtype, quant=False):
        """Packed projection → per-head q, k, v (B, H, S, D) and, with
        rel-pos, the fp32 decomposed bias (B, H, S, h), (B, H, S, w) from
        the unscaled q (JAX vit.py:330-379)."""
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        qkv = _policy_dot(tokens, self.qkv.weight, self.qkv.bias,
                          dtype, quant).to(dtype)
        q, k, v = qkv.reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        if not self.cfg.use_rel_pos:
            return q, k, v, None, None
        rh = _rel_pos_table(self.rel_pos_h.to(dtype), h, h).float()
        rw = _rel_pos_table(self.rel_pos_w.to(dtype), w, w).float()
        qg = q.reshape(b, nh, h, w, hd).float()
        bias_h = torch.einsum("bnyxd,ykd->bnyxk", qg, rh)
        bias_w = torch.einsum("bnyxd,xkd->bnyxk", qg, rw)
        return (q, k, v, bias_h.reshape(b, nh, h * w, h),
                bias_w.reshape(b, nh, h * w, w))

    def _generic_trainable(self, tokens, b, h, w, dtype):
        """The generic trainable path (JAX ``_trainable_flash``, vit.py:
        627-668): K6 over the whole key grid with a bias (windows on the
        batch axis: Kh·Kw == S), else over the tokens padded by
        :func:`_pad_tokens` with ``kv_len``, cut back to S."""
        q, k, v, bias_h, bias_w = self._heads(tokens, b, h, w, dtype)
        s = h * w
        if bias_h is not None:
            out = flash_attention_trainable(
                q.contiguous(), k.contiguous(), v.contiguous(),
                bias_h.contiguous(), bias_w.contiguous())
        else:
            (q, k, v), kv_len = _pad_tokens((q, k, v), s)
            out = flash_attention_trainable(
                q.contiguous(), k.contiguous(), v.contiguous(),
                kv_len=kv_len)[:, :, :s]
        return out.transpose(1, 2).reshape(b, s, -1)

    def _flash(self, q, k, v, bias_h, bias_w, h, w):
        """The generic path (JAX vit.py:670-739): pad the key grid (rows to
        a multiple of 8, columns to a power of two ≥ 8) and run K3 with
        ``kv_grid`` when the grid was padded; without a bias, pad the keys
        to ``_q_blocking``'s length and mask them by ``kv_len``. Returns
        (B, H, S, D).

        JAX also pads the queries to ``_q_blocking``'s length (its TPU
        grid-step rule) and cuts the padded rows off the output. A query
        row's output depends on that row alone, so K3 gets the S rows the
        caller keeps (``block_q`` = S: one block, JAX's divisibility rule
        holds), except in ``window_group`` mode, whose block-diagonal call
        needs Sq == Sk."""
        b, nh, s, hd = q.shape
        sq_pad, bq = _q_blocking(s)
        if bias_h is not None:
            hp = -(-h // 8) * 8
            wp = max(8, 1 << (w - 1).bit_length())
            sk_pad = hp * wp

            def grid(t):            # (B, H, h·w, D) → padded (B, H, hp·wp, D)
                t = t.reshape(b, nh, h, w, hd)
                return _pad_to(_pad_to(t, hp, 2), wp, 3).reshape(
                    b, nh, sk_pad, hd)

            kp, vp = grid(k), grid(v)
            bh = _pad_to(bias_h, hp, 3).to(q.dtype)
            bw = _pad_to(bias_w, wp, 3).to(q.dtype)
            if self.window_group > 1 and sq_pad == sk_pad and \
                    sk_pad * self.window_group <= 1024:
                qp, bhp, bwp = (_pad_to(t, sq_pad, 2) for t in (q, bh, bw))
                out = self._flash_grouped(qp, kp, vp, bhp, bwp, (h, w),
                                          sq_pad)
                return out[:, :, :s]
            return flash_attention(
                *(t.contiguous() for t in (q, kp, vp, bh, bw)),
                kv_grid=(h, w) if (hp, wp) != (h, w) else None,
                block_q=s, block_k=min(1024, sk_pad))
        kv_len = None
        if sq_pad != s:
            kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
        kp, vp = (_pad_to(t, sq_pad, 2).contiguous() for t in (k, v))
        return flash_attention(q.contiguous(), kp, vp, kv_len=kv_len,
                               block_q=s, block_k=bq)

    def _flash_grouped(self, qp, kp, vp, bh, bw, grid_hw, win):
        """``window_group`` windows per K3 block-diagonal call (JAX vit.py:
        741-770): the batch axis is grouped into the token axis, the bias
        stays per window and the kv_grid mask keeps each window to
        itself."""
        g = self.window_group
        b, nh, _, hd = qp.shape
        pad_b = (-b) % g

        def group(x):
            if pad_b:
                x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad_b))
            bb = x.shape[0] // g
            x = x.reshape(bb, g, nh, win, x.shape[-1])
            return x.transpose(1, 2).reshape(bb, nh, g * win, -1) \
                .contiguous()

        out = flash_attention(
            group(qp), group(kp), group(vp), group(bh), group(bw),
            kv_grid=grid_hw, window_tokens=win, block_q=g * win,
            block_k=g * win)
        bb = out.shape[0]
        out = out.reshape(bb, nh, g, win, hd).transpose(1, 2)
        out = out.reshape(bb * g, nh, win, hd)
        return out[:b] if pad_b else out

    def _oracle(self, tokens, b, h, w, dtype, quant=False):
        """Plain attention path (JAX use_flash=False): packed projection,
        fp32 bias einsums, dense bias cast to the compute dtype."""
        q, k, v, bias_h, bias_w = self._heads(tokens, b, h, w, dtype, quant)
        dense = None
        if bias_h is not None:
            dense = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
                b, q.shape[1], h * w, h * w).to(dtype)
        out = attention_reference(q, k, v, bias=dense)
        return out.transpose(1, 2).reshape(b, h * w, -1)


class Mlp(nn.Module):
    """Two Linears with GELU between, under the reference names: SAM's
    ``lin1``/``lin2``, DINOv2's ``fc1``/``fc2``."""

    def __init__(self, cfg: ViTDenseConfig, trainable: bool = False):
        super().__init__()
        hidden = int(cfg.mlp_ratio * cfg.width)
        self.trainable = trainable
        self.names = ("fc1", "fc2") if cfg.use_cls_token else ("lin1", "lin2")
        self.add_module(self.names[0], nn.Linear(cfg.width, hidden))
        self.add_module(self.names[1], nn.Linear(hidden, cfg.width))

    def layers(self):
        return tuple(getattr(self, n) for n in self.names)

    def forward(self, x, policy: Policy):
        dtype = policy.compute_dtype
        quant = policy.quantized and not self.trainable
        first, second = self.layers()
        x = _policy_dot(x, first.weight, first.bias, dtype, quant)
        # erf GELU under fp32, tanh approximation on the bf16 path and
        # straight off the dequantized int8 accumulator (JAX vit.py:808)
        x = F.gelu(x, approximate="tanh" if quant or dtype == torch.bfloat16
                   else "none")
        x = _policy_dot(x, second.weight, second.bias, dtype, quant)
        return x.to(dtype)


class LayerScale(nn.Module):
    """DINOv2's per-channel residual scale ``gamma`` (JAX ``ls1``/``ls2``),
    applied in the compute dtype."""

    def __init__(self, width: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((width,), float(init)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


def window_partition(x, window: int):
    """(B, H, W, C) → (B·nh·nw, window, window, C) with bottom/right zero
    padding; the padded tokens take part in attention, as in SAM."""
    b, h, w, c = x.shape
    ph = -(-h // window) * window
    pw = -(-w // window) * window
    x = F.pad(x, (0, 0, 0, pw - w, 0, ph - h))
    nh, nw = ph // window, pw // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window, window, c), (h, w, ph, pw)


def window_unpartition(x, window: int, dims):
    h, w, ph, pw = dims
    nh, nw = ph // window, pw // window
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, ph, pw, c)[:, :h, :w]


class Block(nn.Module):
    def __init__(self, cfg: ViTDenseConfig, windowed: bool, use_flash: bool,
                 trainable: bool = False, remat_mlp: bool = False):
        super().__init__()
        self.cfg = cfg
        self.windowed = windowed
        self.use_flash = use_flash
        self.trainable = trainable
        self.remat_mlp = remat_mlp
        # True/False fixes the K7 gate for this block (a loaded serving
        # artifact routes as its header says); None reads VDR_FUSED_MLP
        self.fused_mlp: bool | None = None
        self.norm1 = LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.attn = WindowedAttention(
            cfg, cfg.window_size if windowed else cfg.grid,
            use_flash=use_flash, trainable=trainable)
        self.norm2 = LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg, trainable=trainable)
        if cfg.layerscale_init:
            self.ls1 = LayerScale(cfg.width, cfg.layerscale_init)
            self.ls2 = LayerScale(cfg.width, cfg.layerscale_init)

    def forward(self, x, policy: Policy):
        shortcut = x
        y = self.norm1(x)
        if self.windowed:
            y, dims = window_partition(y, self.cfg.window_size)
        y = self.attn(y, policy)
        if self.windowed:
            y = window_unpartition(y, self.cfg.window_size, dims)
        if self.cfg.layerscale_init:
            y = self.ls1(y)
        x = shortcut + y
        if self._fused_mlp_on(policy):
            # LayerNorm → MLP → residual in one K7 call, on the parameters
            # of the modules (JAX vit.py:914-927)
            first, second = self.mlp.layers()
            return fused_ln_mlp_residual(
                x, self.norm2.weight, self.norm2.bias, first.weight.t(),
                first.bias, second.weight.t(), second.bias,
                self.ls2.gamma if self.cfg.layerscale_init else None,
                eps=self.norm2.eps)
        y = self.norm2(x)
        if self.remat_mlp and torch.is_grad_enabled():
            # selective remat: only the (B, S, 4C) hidden activations are
            # recomputed in the backward (JAX vit.py:890-897)
            y = checkpoint(self.mlp, y, policy, use_reentrant=False)
        else:
            y = self.mlp(y, policy)
        if self.cfg.layerscale_init:
            y = self.ls2(y)
        return x + y

    def _fused_mlp_on(self, policy: Policy) -> bool:
        """JAX's gate: frozen, flash, bf16, not quantized, and opted in
        with ``VDR_FUSED_MLP=1`` (or by :attr:`fused_mlp`)."""
        opted = os.environ.get("VDR_FUSED_MLP", "0") == "1" \
            if self.fused_mlp is None else self.fused_mlp
        return (not self.trainable and self.use_flash
                and policy.compute_dtype == torch.bfloat16
                and not policy.quantized and opted)


class SamNeck(nn.Sequential):
    """SAM neck: 1×1 conv → channel LayerNorm → 3×3 conv ("SAME") →
    channel LayerNorm, on NHWC activations. Submodule indexes give the
    reference names ``neck.0`` … ``neck.3``."""

    def __init__(self, cfg: ViTDenseConfig):
        out_c = cfg.neck_channels
        super().__init__(
            nn.Conv2d(cfg.width, out_c, 1, bias=False),
            LayerNorm(out_c, eps=cfg.ln_eps),
            nn.Conv2d(out_c, out_c, 3, padding=1, bias=False),
            LayerNorm(out_c, eps=cfg.ln_eps),
        )

    def forward(self, x, policy: Policy):          # (B, hp, wp, width)
        dtype = policy.compute_dtype
        w1 = self[0].weight.reshape(self[0].out_channels, -1)
        x = _policy_dot(x, w1, None, dtype).to(dtype)
        x = self[1](x)
        x = F.conv2d(x.permute(0, 3, 1, 2), self[2].weight.to(dtype),
                     padding=1)
        return self[3](x.permute(0, 2, 3, 1))


class ViTDense(nn.Module):
    """Dense-descriptor ViT.

    ``forward(images)`` takes (B, H, W, 3) in [0, 1] and returns, in the
    policy's output dtype, the port of JAX ``ViTDense``'s output:

    * SAM config → the (B, grid, grid, neck_channels) neck feature map;
    * DINOv2 config → the normalised patch tokens after the full
      transformer as a (B, H/p, W/p, width) map (JAX's full mode). The
      position embedding is resized bicubically, as ``jax.image.resize``
      does, when the image is not the config's size;
    * ``patch_embed_only=True`` → the patch embedding alone as a (B, H/p,
      W/p, width) map, what the reference's ``model.patch_embed(img)``
      gives (JAX vit.py:1009-1010); the model then holds ``patch_embed``
      and nothing else, as the JAX module creates no other parameter.

    ``trainable`` selects the differentiable attention kernels; ``remat``
    (only with ``trainable``) is False/'none', True/'block' (recompute
    whole blocks in the backward) or 'mlp' (recompute only the MLP).
    """

    def __init__(self, cfg: ViTDenseConfig, policy: Policy = FAST,
                 use_flash: bool = True, trainable: bool = False,
                 remat: bool | str = False, patch_embed_only: bool = False):
        super().__init__()
        remat_mode = {False: "none", True: "block"}.get(remat, remat)
        if remat_mode not in ("none", "block", "mlp"):
            raise ValueError(
                f"remat must be False/'none', True/'block' or 'mlp', "
                f"got {remat!r}")
        self.cfg = cfg
        self.policy = policy
        self.remat_block = trainable and remat_mode == "block"
        self.patch_embed_only = patch_embed_only
        self.patch_embed = PatchEmbed(cfg)
        if not patch_embed_only:
            self._build_transformer(use_flash, trainable, remat_mode)
        if policy.param_dtype != torch.float32:
            cast_params(self, policy.param_dtype)

    def _build_transformer(self, use_flash, trainable, remat_mode):
        """Position embedding, blocks, and the final norm or the neck."""
        cfg = self.cfg
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
            self.pos_embed = nn.Parameter(
                torch.zeros(1, cfg.grid * cfg.grid + 1, cfg.width))
        else:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, cfg.grid, cfg.grid, cfg.width))
        self.blocks = nn.ModuleList(
            Block(cfg,
                  windowed=(cfg.window_size > 0
                            and i not in tuple(cfg.global_indexes)),
                  use_flash=use_flash, trainable=trainable,
                  remat_mlp=trainable and remat_mode == "mlp")
            for i in range(cfg.depth))
        if cfg.use_cls_token:
            self.norm = LayerNorm(cfg.width, eps=cfg.ln_eps)
        if cfg.neck_channels:
            self.neck = SamNeck(cfg)

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "ViTDense":
        """Seeded random weights (LeCun-normal matrices, small biases,
        non-zero rel-pos tables so every bias path is exercised, LayerScale
        gammas about 0.1 so the residual branches count)."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("rel_pos_h") or name.endswith("rel_pos_w") \
                    or name in ("pos_embed", "cls_token"):
                val = torch.randn(p.shape, generator=gen) * 0.02 * (
                    10.0 if "rel_pos" in name else 1.0)
            elif name.endswith(".gamma"):
                val = 0.1 + 0.02 * torch.randn(p.shape, generator=gen)
            elif p.ndim >= 2:
                fan_in = math.prod(p.shape[1:])
                val = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
            elif "norm" in name or name.startswith("neck.") \
                    and p.ndim == 1 and name.endswith("weight"):
                val = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            else:
                val = 0.02 * torch.randn(p.shape, generator=gen)
            p.copy_(val.to(p.dtype))
        return self

    def forward(self, images):
        cfg, policy = self.cfg, self.policy
        with policy.backends():
            x = self.patch_embed(policy.cast_input(images), policy)
            if self.patch_embed_only:
                return policy.cast_output(x)
            b, hp, wp, c = x.shape
            if cfg.use_cls_token:
                x = self._tokens(x)
            else:
                x = x + self.pos_embed.to(x.dtype)
            for blk in self.blocks:
                if self.remat_block and torch.is_grad_enabled():
                    x = checkpoint(blk, x, policy, use_reentrant=False)
                else:
                    x = blk(x, policy)
            if cfg.use_cls_token:
                # final norm, the patch tokens back on the grid
                x = self.norm(x[:, 0])[:, 1:].reshape(b, hp, wp, c)
            if cfg.neck_channels:
                x = self.neck(x, policy)
        return policy.cast_output(x)

    def _tokens(self, x):
        """CLS + patch tokens with their position embedding, as a (B, 1,
        N, C) grid for the blocks (JAX vit.py:1012-1036)."""
        b, hp, wp, c = x.shape
        g = self.cfg.grid
        pos_patch, pos_cls = self.pos_embed[:, 1:], self.pos_embed[:, :1]
        if hp * wp != pos_patch.shape[1]:
            pos_patch = resize_bicubic(pos_patch.reshape(1, g, g, c), hp,
                                       wp).reshape(1, hp * wp, c)
        tokens = x.reshape(b, hp * wp, c) + pos_patch.to(x.dtype)
        cls_tok = (self.cls_token + pos_cls).to(x.dtype).expand(b, 1, c)
        return torch.cat([cls_tok, tokens], dim=1)[:, None]
