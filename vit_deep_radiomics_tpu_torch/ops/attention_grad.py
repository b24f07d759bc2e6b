"""Trainable attention: autograd Functions over the CUDA kernels.

Counterpart of ``vit_deep_radiomics_tpu/ops/attention_grad.py``, with the
port's per-head bias layout (``bias_h (B, H, S, Kh)``, ``bias_w (B, H, S,
Kw)``, as in ``ops/attention.py``):

* :func:`window_attention_trainable` — forward K1
  (``csrc/fused_window_attention.cu``, max softmax), backward K4
  (``csrc/window_attention_bwd.cu``): one pass per window and head, a TMA +
  wgmma body for windows of at most 208 tokens and mma.sync loops beyond;
  :func:`window_attention_bwd_route` says which.
* :func:`global_attention_trainable` — forward K5
  (``csrc/global_attention_fwd_lse.cu``: K2's function plus a per-row
  log2 log-sum-exp residual, on K2's Hopper body,
  ``csrc/global_fwd_hopper.cuh``, scoring as the backward rebuilds a
  score), backward the K5 dq kernel (``csrc/global_attention_bwd_dq.cu``:
  dq and both bias gradients over the keys) and the K5 dkv kernel
  (``csrc/global_attention_bwd_dkv.cu``: dk and dv over the queries). All
  three run a TMA + wgmma body on calls with no bias or a key grid 64 or
  128 keys wide (Kw 128: SAM's global layers at 2048 px) of at most 128
  grid rows, and mma.sync loops on the other widths;
  :func:`global_attention_fwd_route` and :func:`global_attention_bwd_route`
  say which.
* :func:`flash_attention_trainable` — K6, the generic per-head
  ``(B, H, S, D)`` path of ``parity`` (fp32) fine-tuning, and of ``fast``
  (bf16) fine-tuning at grids the fused kernels refuse (SAM's global layers
  at 768 px: 48 x 48 tokens): forward with the lse residual
  (``csrc/flash_attention_fwd.cu``), dq with both bias gradients
  (``csrc/flash_attention_bwd_dq.cu``) and dk/dv
  (``csrc/flash_attention_bwd_dkv.cu``), any key-grid width. fp32 calls
  run the register-tiled CUDA-core bodies (``csrc/f32_tiled_forward.cuh``,
  ``csrc/flash_trainable_core.cuh``), bf16 calls with no bias or a key
  grid of at most 128 rows whose width is even from 16 to 128 (SAM @544 to
  @1536: Kw 34 to 96) the TMA + wgmma bodies of
  ``csrc/flash_trainable_hopper.cuh`` in the backward, and in the forward
  where the width is also a multiple of 4 (SAM @576 up), and other bf16
  calls the mma.sync bodies of ``csrc/flash_trainable_bf16.cuh`` (fp32
  bias, lse and bias gradients); :func:`flash_attention_route` says which
  body the forward runs, :func:`flash_attention_bwd_route` the backward
  (one choice for dq and dkv; the forward's at Kw 2 mod 4 is the mma.sync
  body, the backward's the Hopper ones).

The backward formulas, with ``P`` the softmax of the scores and ``O`` the
forward's output, natural units::

    D  = Σ_d dO∘O          dP = dO·Vᵀ          dS = P∘(dP − D)
    dq = scale·dS·K        dk = scale·dSᵀ·Q     dv = Pᵀ·dO
    dbias_h[i, r] = Σ_{key j in grid row r} dS[i, j]
    dbias_w[i, c] = Σ_{key j in grid column c} dS[i, j]

Each kernel has a plain PyTorch version beside it that writes out the same
formulas in fp32 (K6's with the JAX kernels' bf16 rounding points on bf16
operands); the wrappers take it for CPU tensors only, and for CUDA tensors
launch their kernel or raise. K4 and K5 build bf16 only, K6 fp32 and
bf16, all of them head dim 64 only. Launches are counted in
``ops/_kernels.py::LAUNCHES``, K6's bf16 mma.sync bodies under their own
names (``flash_attention_fwd_bf16`` and so on), and its Hopper bodies under
theirs (``flash_attention_fwd_hopper``, ``flash_attention_bwd_dq_hopper``,
``flash_attention_bwd_dkv_hopper``): the bf16 entries report the body each
launch ran.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._kernels import (LAUNCHES, _DTYPE_CODES, _F, _I, _P, _load, _ptr,
                       register_launches)
from .attention import (_check_cuda, _check_layout, _heads, _raise_on,
                        fused_global_attention_plain, fused_window_attention)

__all__ = [
    "window_attention_trainable",
    "global_attention_trainable",
    "attention_delta",
    "window_attention_bwd",
    "window_attention_bwd_plain",
    "window_attention_bwd_route",
    "global_attention_fwd_lse",
    "global_attention_fwd_lse_plain",
    "global_attention_fwd_route",
    "global_attention_bwd_dq",
    "global_attention_bwd_dq_plain",
    "global_attention_bwd_dkv",
    "global_attention_bwd_dkv_plain",
    "global_attention_bwd_route",
    "flash_attention_trainable",
    "flash_attention_delta",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_plain",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_plain",
    "flash_attention_route",
    "flash_attention_bwd_route",
]

register_launches("window_attention_bwd", "global_attention_fwd_lse",
                  "global_attention_bwd_dq", "global_attention_bwd_dkv",
                  *(f"flash_attention_{k}{suffix}"
                    for suffix in ("", "_bf16")
                    for k in ("fwd", "bwd_dq", "bwd_dkv")),
                  *(f"flash_attention_{k}_hopper"
                    for k in ("fwd", "bwd_dq", "bwd_dkv")))

_NEG_INF = -1e30
_LOG2E = math.log2(math.e)
# key-grid widths the K5 kernels take with a bias: an 8-key mma tile lies in
# one grid row, and a 64-key tile holds whole grid rows or half of one (Kw
# 128, SAM's global grid at 2048 px, which the Hopper bodies take)
_K5_BIAS_WIDTHS = (8, 16, 32, 64, 128)
# K6's builds: fp32 (register-tiled CUDA-core bodies) and bf16 (mma.sync
# or Hopper bodies)
_K6_DTYPES = (torch.float32, torch.bfloat16)
# the codes of vdr_flash_attention_route (csrc/flash_attention_fwd.cu) and
# vdr_flash_attention_bwd_route (csrc/flash_attention_bwd_dq.cu), and the
# suffix of each body's launch counter
_K6_ROUTES = ("tiled", "mma", "hopper")
_K6_COUNTERS = ("", "_bf16", "_hopper")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _dense(q, kv, bias_h, bias_w, kv_len, num_heads, seg, scale):
    """fp32 per-segment operands and natural-unit scores.

    Returns qh, kh, vh (B·nseg, H, seg, D) and s (B·nseg, H, seg, seg)."""
    b, s, c = q.shape
    nseg = s // seg
    qh = _heads(q, nseg, seg, num_heads).float()
    kh = _heads(kv[..., :c], nseg, seg, num_heads).float()
    vh = _heads(kv[..., c:], nseg, seg, num_heads).float()
    sc = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if bias_h is not None:
        bh, bw = (_per_seg(t, nseg, seg).float() for t in (bias_h, bias_w))
        sc = sc + (bh[..., :, None] + bw[..., None, :]).reshape(sc.shape)
    if kv_len is not None:
        key = torch.arange(seg, device=q.device)
        valid = key[None, :] < kv_len.to(q.device)[:, None]        # (B, seg)
        sc = torch.where(valid[:, None, None, :], sc,
                         torch.full_like(sc, _NEG_INF))
    return qh, kh, vh, sc


def _per_seg(t, nseg, seg):
    """(B, H, nseg·seg, K) → (B·nseg, H, seg, K)."""
    b, h, _, k = t.shape
    return t.reshape(b, h, nseg, seg, k).transpose(1, 2).reshape(
        b * nseg, h, seg, k)


def _merge_rows(x, b, nseg):
    """(B·nseg, H, seg, X) → (B, nseg·seg, H·X)."""
    _, h, seg, d = x.shape
    return x.reshape(b, nseg, h, seg, d).permute(0, 1, 3, 2, 4).reshape(
        b, nseg * seg, h * d)


def _merge_bias(x, b, nseg):
    """(B·nseg, H, seg, K) → (B, H, nseg·seg, K)."""
    _, h, seg, k = x.shape
    return x.reshape(b, nseg, h, seg, k).transpose(1, 2).reshape(
        b, h, nseg * seg, k)


def _grads(q, kv, bias_h, bias_w, p, ds, qh, kh, vh, doh, seg, scale):
    """dq, dkv, dbias_h, dbias_w from P and dS, in the callers' layouts."""
    b, s, c = q.shape
    nseg = s // seg
    dq = _merge_rows(torch.matmul(ds, kh) * scale, b, nseg).to(q.dtype)
    dk = _merge_rows(torch.matmul(ds.transpose(-1, -2), qh) * scale, b, nseg)
    dv = _merge_rows(torch.matmul(p.transpose(-1, -2), doh), b, nseg)
    dkv = torch.cat([dk, dv], dim=-1).to(kv.dtype)
    dbh = dbw = None
    if bias_h is not None:
        kh_, kw_ = bias_h.shape[-1], bias_w.shape[-1]
        grid = ds.reshape(*ds.shape[:-1], kh_, kw_)
        dbh = _merge_bias(grid.sum(-1), b, nseg).to(bias_h.dtype)
        dbw = _merge_bias(grid.sum(-2), b, nseg).to(bias_w.dtype)
    return dq, dkv, dbh, dbw


def attention_delta(out, dout, num_heads):
    """D = Σ_d dO∘O per row and head: (B, S, H·D) pair → (B, H, S) fp32."""
    b, s, c = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, s, num_heads, c // num_heads).sum(-1) \
        .transpose(1, 2).contiguous()


def window_attention_bwd_plain(q, kv, bias_h, bias_w, out, dout, *,
                               num_heads, window_tokens, scale):
    """Plain version of K4: exact softmax recomputed per window, then
    D, dP, dS and the five gradients in fp32."""
    seg = window_tokens
    qh, kh, vh, sc = _dense(q, kv, bias_h, bias_w, None, num_heads, seg,
                            scale)
    p = torch.softmax(sc, dim=-1)
    b, s, _ = q.shape
    nseg = s // seg
    doh = _heads(dout, nseg, seg, num_heads).float()
    delta = _per_seg(attention_delta(out, dout, num_heads)[..., None],
                     nseg, seg)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)
    return _grads(q, kv, bias_h, bias_w, p, ds, qh, kh, vh, doh, seg, scale)


def global_attention_fwd_lse_plain(q, kv, bias_h, bias_w, kv_len, *,
                                   num_heads, scale):
    """Plain version of the K5 forward: K2's plain output and the log2
    log-sum-exp of each row's scores, (B, H, S) fp32."""
    out = fused_global_attention_plain(q, kv, bias_h, bias_w, kv_len,
                                       num_heads=num_heads, scale=scale)
    _, _, _, sc = _dense(q, kv, bias_h, bias_w, kv_len, num_heads,
                         q.shape[1], scale)
    lse = torch.logsumexp(sc, dim=-1) * _LOG2E
    return out, lse.contiguous()


def _global_p_ds(q, kv, bias_h, bias_w, kv_len, dout, lse, delta,
                 num_heads, scale):
    seg = q.shape[1]
    qh, kh, vh, sc = _dense(q, kv, bias_h, bias_w, kv_len, num_heads, seg,
                            scale)
    p = torch.exp2(sc * _LOG2E - lse[..., None])
    doh = _heads(dout, 1, seg, num_heads).float()
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta[..., None])
    return _grads(q, kv, bias_h, bias_w, p, ds, qh, kh, vh, doh, seg, scale)


def global_attention_bwd_dq_plain(q, kv, bias_h, bias_w, kv_len, dout, lse,
                                  delta, *, num_heads, scale):
    """Plain version of the K5 dq kernel: P from the residual, then dq
    and both bias gradients."""
    dq, _, dbh, dbw = _global_p_ds(q, kv, bias_h, bias_w, kv_len, dout, lse,
                                   delta, num_heads, scale)
    return dq, dbh, dbw


def global_attention_bwd_dkv_plain(q, kv, bias_h, bias_w, kv_len, dout, lse,
                                   delta, *, num_heads, scale):
    """Plain version of the K5 dkv kernel: P from the residual, then dk
    and dv as one (B, S, 2·H·D) array."""
    return _global_p_ds(q, kv, bias_h, bias_w, kv_len, dout, lse, delta,
                        num_heads, scale)[1]


def _round(x, dtype, acc=torch.float32):
    """x rounded to ``dtype`` and widened back to ``acc``: a no-op for fp32
    in fp32, the JAX kernels' rounding points on bf16 operands."""
    return x.to(dtype).to(acc)


def _out(x, dtype, acc):
    """An output in ``dtype``, or unrounded where the sums run in fp64 (the
    oracle of the rounding points)."""
    return x if acc == torch.float64 else x.to(dtype)


def _flash_scores(q, k, bias_h, bias_w, kv_len, scale, acc=torch.float32):
    """K6's scores in log2 units, (B, H, S, S), summed in ``acc``: Q^·kᵀ +
    t(bias_h[i, j // Kw]) + t(bias_w[i, j % Kw]), keys j ≥ kv_len at
    -1e30 (JAX ``_fwd_kernel`` and ``_recompute_p_ds``). Q^ = q times
    scale·log2(e), and t(x) = x·log2(e), both in q's dtype as JAX rounds
    them: on bf16 q the constant scale·log2(e) is itself a bf16 (JAX's weak
    type), Q^ and each bias term are rounded to bf16 (the term's product
    taken in fp32, as the kernels take it), and the two terms are added
    before they join the score."""
    scale2 = torch.tensor(scale * _LOG2E, dtype=torch.float64) \
        .to(q.dtype).item()
    s = torch.matmul(_round(q.to(acc) * scale2, q.dtype, acc),
                     k.to(acc).transpose(-1, -2))
    if bias_h is not None:
        bh, bw = (_round(t.float() * _LOG2E, q.dtype, acc)
                  for t in (bias_h, bias_w))
        s = s + (bh[..., :, None] + bw[..., None, :]).flatten(-2)
    if kv_len is not None:
        key = torch.arange(k.shape[2], device=q.device)
        valid = key[None, :] < kv_len.to(q.device)[:, None]        # (B, S)
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
    return s


def flash_attention_fwd_plain(q, k, v, bias_h, bias_w, kv_len, *, scale,
                              acc=torch.float32):
    """Plain version of the K6 forward: (out, lse) with lse (B, H, S) the
    log2 log-sum-exp of each row's scores, fp32; P rounded to v's dtype
    before P·V, the row sums taken on the unrounded P (JAX :121). ``acc``
    is the type of the sums between the rounding points: fp32, or fp64 for
    the oracle those points define (outputs then fp64, unrounded)."""
    s = _flash_scores(q, k, bias_h, bias_w, kv_len, scale, acc)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(_round(e, v.dtype, acc), v.to(acc)) / l
    return (_out(out, q.dtype, acc),
            (m + torch.log2(l)).squeeze(-1).contiguous())


def flash_attention_delta(out, dout):
    """D = Σ_d dO∘O per row: (B, H, S, D) pair → (B, H, S) fp32."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def _flash_p_ds(q, k, v, bias_h, bias_w, kv_len, dout, lse, delta, scale,
                acc=torch.float32):
    """P from the residual and the natural-unit score gradient dS, in
    ``acc``; dP = dO·Vᵀ on dO rounded to v's dtype."""
    p = torch.exp2(_flash_scores(q, k, bias_h, bias_w, kv_len, scale, acc)
                   - lse[..., None].to(acc))
    dp = torch.matmul(_round(dout.to(acc), v.dtype, acc),
                      v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta[..., None].to(acc))


def flash_attention_bwd_dq_plain(q, k, v, bias_h, bias_w, kv_len, dout, lse,
                                 delta, *, scale, acc=torch.float32):
    """Plain version of the K6 dq kernel: (dq, dbias_h, dbias_w), the bias
    gradients the sums of dS over each key-grid row and column. dS is
    rounded to q's dtype before the product and the sums (JAX :230,
    :242). ``acc`` as in :func:`flash_attention_fwd_plain`."""
    _, ds = _flash_p_ds(q, k, v, bias_h, bias_w, kv_len, dout, lse, delta,
                        scale, acc)
    ds = _round(ds, q.dtype, acc)
    dq = _out(torch.matmul(ds, k.to(acc)) * scale, q.dtype, acc)
    if bias_h is None:
        return dq, None, None
    grid = ds.reshape(*ds.shape[:-1], bias_h.shape[-1], bias_w.shape[-1])
    return (dq, _out(grid.sum(-1), bias_h.dtype, acc),
            _out(grid.sum(-2), bias_w.dtype, acc))


def flash_attention_bwd_dkv_plain(q, k, v, bias_h, bias_w, kv_len, dout, lse,
                                  delta, *, scale, acc=torch.float32):
    """Plain version of the K6 dkv kernel: (dk, dv), dS rounded to q's
    dtype and P to dO's before the products (JAX :242, :309). ``acc`` as in
    :func:`flash_attention_fwd_plain`."""
    p, ds = _flash_p_ds(q, k, v, bias_h, bias_w, kv_len, dout, lse, delta,
                        scale, acc)
    dk = torch.matmul(_round(ds, q.dtype, acc).transpose(-1, -2),
                      q.to(acc)) * scale
    dv = torch.matmul(_round(p, dout.dtype, acc).transpose(-1, -2),
                      dout.to(acc))
    return _out(dk, k.dtype, acc), _out(dv, v.dtype, acc)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_bwd_cuda(q, d, *tensors, fp32=(), dtype=(torch.bfloat16,)):
    """What a trainable kernel needs: a dtype it has a build for (``dtype``:
    K4 and K5 bf16, K6 fp32 and bf16), then ``_check_cuda``'s launch needs
    for the operands; the ``fp32`` tensors (the lse and delta residuals,
    K6's bias factors) float32 and contiguous on q's device."""
    if q.dtype not in dtype:
        raise TypeError(f"this trainable kernel takes "
                        f"{' or '.join(map(str, dtype))}, got {q.dtype}")
    _check_cuda(q, d, *tensors)
    for t in fp32:
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("lse, delta and K6's bias must be contiguous, "
                             f"16-byte aligned float32 on {q.device}")


def _check_k5_bias(kw):
    if kw and kw not in _K5_BIAS_WIDTHS:
        raise ValueError(f"the K5 kernels take a key-grid width in "
                         f"{_K5_BIAS_WIDTHS} with a bias, got {kw}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _kv_len_i32(kv_len, q):
    if kv_len is None:
        return None
    return kv_len.to(device=q.device, dtype=torch.int32).contiguous()


def window_attention_bwd(q, kv, bias_h, bias_w, out, dout, *, num_heads,
                         window_tokens, scale):
    """K4 wrapper: (dq, dkv, dbias_h, dbias_w). CPU tensors take the plain
    version; CUDA tensors launch ``csrc/window_attention_bwd.cu``."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, None, num_heads,
                              window_tokens)
    if q.device.type == "cpu":
        return window_attention_bwd_plain(
            q, kv, bias_h, bias_w, out, dout, num_heads=num_heads,
            window_tokens=window_tokens, scale=scale)
    _check_bwd_cuda(q, d, kv, bias_h, bias_w, out, dout)
    b, s, _ = q.shape
    lib, fn = _load("window_attention_bwd",
                    [_P] * 10 + [_I] * 7 + [_F, _P])
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    dbh = torch.empty_like(bias_h) if bias_h is not None else None
    dbw = torch.empty_like(bias_w) if bias_w is not None else None
    rc = fn(_ptr(q), _ptr(kv), _ptr(bias_h), _ptr(bias_w), _ptr(out),
            _ptr(dout), _ptr(dq), _ptr(dkv), _ptr(dbh), _ptr(dbw),
            b, s, num_heads, d, window_tokens, kh, kw, scale, _stream(q))
    _raise_on(rc, lib, "window_attention_bwd")
    LAUNCHES["window_attention_bwd"] += 1
    return dq, dkv, dbh, dbw


def window_attention_bwd_route(q, kv, bias_h=None, bias_w=None, *, num_heads,
                              window_tokens, scale) -> str:
    """Which body :func:`window_attention_bwd` runs for these operands:
    ``"plain"`` on the CPU; on the card, as ``csrc/window_attention_bwd.cu``
    chooses, ``"hopper"`` (the TMA + wgmma kernel: windows of at most 208
    tokens, at most 63 bias terms, 1/scale a power of two) or ``"loops"``
    (the mma.sync loops)."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, None, num_heads,
                              window_tokens)
    if q.device.type == "cpu":
        return "plain"
    _check_bwd_cuda(q, d, kv, bias_h, bias_w)
    _, fn = _load("window_attention_bwd", [_I] * 7 + [_F],
                  entry="vdr_window_attention_bwd_route")
    hopper = fn(q.shape[1], num_heads, d, window_tokens, kh, kw,
                int(bias_h is not None), scale)
    return "hopper" if hopper else "loops"


def global_attention_fwd_lse(q, kv, bias_h, bias_w, kv_len, *, num_heads,
                             scale):
    """K5 forward wrapper: (out, lse), lse (B, H, S) fp32 in log2 units.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/global_attention_fwd_lse.cu``."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, None)
    if q.device.type == "cpu":
        return global_attention_fwd_lse_plain(
            q, kv, bias_h, bias_w, kv_len, num_heads=num_heads, scale=scale)
    _check_bwd_cuda(q, d, kv, bias_h, bias_w)
    _check_k5_bias(kw)
    b, s, _ = q.shape
    lib, fn = _load("global_attention_fwd_lse",
                    [_P] * 7 + [_I] * 6 + [_F, _P])
    out = torch.empty_like(q)
    lse = torch.empty(b, num_heads, s, device=q.device, dtype=torch.float32)
    rc = fn(_ptr(q), _ptr(kv), _ptr(bias_h), _ptr(bias_w),
            _ptr(_kv_len_i32(kv_len, q)), _ptr(out), _ptr(lse),
            b, s, num_heads, d, kh, kw, scale, _stream(q))
    _raise_on(rc, lib, "global_attention_fwd_lse")
    LAUNCHES["global_attention_fwd_lse"] += 1
    return out, lse


def global_attention_fwd_route(q, kv, bias_h=None, bias_w=None,
                               kv_len=None, *, num_heads) -> str:
    """Which body :func:`global_attention_fwd_lse` runs for these operands:
    ``"plain"`` on the CPU; on the card, as
    ``csrc/global_attention_fwd_lse.cu`` chooses, ``"hopper"`` (K2's TMA +
    wgmma body with the lse store: no bias or a key grid 64 or 128 keys
    wide of at most 128 rows, as the backward's route) or ``"loops"`` (the
    mma.sync loop, Kw in {8, 16, 32})."""
    return _k5_route("global_attention_fwd_lse",
                     "vdr_global_attention_fwd_route", q, kv, bias_h, bias_w,
                     kv_len, num_heads)


def _k5_route(source, entry, q, kv, bias_h, bias_w, kv_len, num_heads):
    """A K5 kernel's body for these operands: "plain" on the CPU, else the
    answer of ``csrc/<source>.cu``'s ``entry`` after the launch checks."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, None)
    if q.device.type == "cpu":
        return "plain"
    _check_bwd_cuda(q, d, kv, bias_h, bias_w)
    _check_k5_bias(kw)
    _, fn = _load(source, [_I] * 6, entry=entry)
    hopper = fn(q.shape[1], num_heads, d, kh, kw, int(bias_h is not None))
    return "hopper" if hopper else "loops"


def global_attention_bwd_dq(q, kv, bias_h, bias_w, kv_len, dout, lse, delta,
                            *, num_heads, scale):
    """K5 dq wrapper: (dq, dbias_h, dbias_w). CPU tensors take the plain
    version; CUDA tensors launch ``csrc/global_attention_bwd_dq.cu``."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, None)
    if q.device.type == "cpu":
        return global_attention_bwd_dq_plain(
            q, kv, bias_h, bias_w, kv_len, dout, lse, delta,
            num_heads=num_heads, scale=scale)
    _check_bwd_cuda(q, d, kv, bias_h, bias_w, dout, fp32=(lse, delta))
    _check_k5_bias(kw)
    b, s, _ = q.shape
    lib, fn = _load("global_attention_bwd_dq",
                    [_P] * 11 + [_I] * 6 + [_F, _P])
    dq = torch.empty_like(q)
    dbh = torch.empty_like(bias_h) if bias_h is not None else None
    dbw = torch.empty_like(bias_w) if bias_w is not None else None
    rc = fn(_ptr(q), _ptr(kv), _ptr(bias_h), _ptr(bias_w),
            _ptr(_kv_len_i32(kv_len, q)), _ptr(dout), _ptr(lse), _ptr(delta),
            _ptr(dq), _ptr(dbh), _ptr(dbw), b, s, num_heads, d, kh, kw,
            scale, _stream(q))
    _raise_on(rc, lib, "global_attention_bwd_dq")
    LAUNCHES["global_attention_bwd_dq"] += 1
    return dq, dbh, dbw


def global_attention_bwd_dkv(q, kv, bias_h, bias_w, kv_len, dout, lse,
                             delta, *, num_heads, scale):
    """K5 dkv wrapper: dkv (B, S, 2·H·D). CPU tensors take the plain
    version; CUDA tensors launch ``csrc/global_attention_bwd_dkv.cu``."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, None)
    if q.device.type == "cpu":
        return global_attention_bwd_dkv_plain(
            q, kv, bias_h, bias_w, kv_len, dout, lse, delta,
            num_heads=num_heads, scale=scale)
    _check_bwd_cuda(q, d, kv, bias_h, bias_w, dout, fp32=(lse, delta))
    _check_k5_bias(kw)
    b, s, _ = q.shape
    lib, fn = _load("global_attention_bwd_dkv",
                    [_P] * 9 + [_I] * 6 + [_F, _P])
    dkv = torch.empty_like(kv)
    rc = fn(_ptr(q), _ptr(kv), _ptr(bias_h), _ptr(bias_w),
            _ptr(_kv_len_i32(kv_len, q)), _ptr(dout), _ptr(lse), _ptr(delta),
            _ptr(dkv), b, s, num_heads, d, kh, kw, scale, _stream(q))
    _raise_on(rc, lib, "global_attention_bwd_dkv")
    LAUNCHES["global_attention_bwd_dkv"] += 1
    return dkv


def global_attention_bwd_route(q, kv, bias_h=None, bias_w=None,
                               kv_len=None, *, num_heads, kernel="dkv") -> str:
    """Which body the K5 backward kernel ``kernel`` (``"dq"`` or ``"dkv"``)
    runs for these operands: ``"plain"`` on the CPU; on the card, as its
    source's C entry chooses, ``"hopper"`` (the TMA + wgmma kernel: no bias
    or a key grid 64 or 128 keys wide of at most 128 rows) or ``"loops"``
    (the mma.sync loops, Kw in {8, 16, 32})."""
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel must be 'dq' or 'dkv', got {kernel!r}")
    return _k5_route(f"global_attention_bwd_{kernel}",
                     "vdr_global_attention_bwd_route", q, kv, bias_h, bias_w,
                     kv_len, num_heads)


def _check_flash(q, k, v, bias_h, bias_w, kv_len):
    """K6's layout checks (JAX ops/attention_grad.py::_validate, with Sq ==
    Sk, the only case a caller has). Returns (Kh, Kw), 0 without a bias."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (bias_h is None) != (bias_w is None):
        raise ValueError("bias_h and bias_w must be given together")
    b, h, s, _ = q.shape
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len shape {tuple(kv_len.shape)} != ({b},)")
    if bias_h is None:
        return 0, 0
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    if tuple(bias_h.shape) != (b, h, s, kh) or \
            tuple(bias_w.shape) != (b, h, s, kw):
        raise ValueError(f"bias shapes {tuple(bias_h.shape)}, "
                         f"{tuple(bias_w.shape)} != ({b}, {h}, {s}, K)")
    if kh * kw != s:
        raise ValueError(f"Kh*Kw = {kh}*{kw} != Sk = {s}")
    return kh, kw


def _k6_entry(source, q, d, bias_h, bias_w, *tensors, fp32=(), args):
    """(lib, fn): the C entry of a K6 kernel for q's dtype (``vdr_<source>``
    or ``vdr_<source>_bf16``) after the launch checks (k, v and dO in q's
    dtype, the bias factors and residuals fp32). The bf16 entries take one
    pointer more, where they write the code of the body they launched
    (:func:`_k6_launch`)."""
    _check_bwd_cuda(q, d, *tensors, fp32=(bias_h, bias_w, *fp32),
                    dtype=_K6_DTYPES)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        args = args + [_P]
    return _load(source, args,
                 entry=f"vdr_{source}" + ("_bf16" if bf16 else ""))


def _k6_launch(lib, fn, source, q, *c_args):
    """Launch a K6 entry (forward, dq or dkv) and count the launch under
    the body that ran: ``<source>`` for fp32 (the tiled bodies), and in
    bf16 as the entry reports through its last argument, ``<source>_bf16``
    for the mma.sync bodies or ``<source>_hopper`` for the Hopper ones."""
    body = ctypes.c_int(0)
    extra = (ctypes.byref(body),) if q.dtype == torch.bfloat16 else ()
    _raise_on(fn(*c_args, *extra), lib, source)
    LAUNCHES[source + _K6_COUNTERS[body.value]] += 1


def _k6_route(source, q, bias_h, bias_w):
    """The body name a K6 route entry gives for these operands
    (``vdr_flash_attention_route`` of the forward's source, or the
    backward's one choice for dq and dkv, ``vdr_flash_attention_bwd_route``
    of the dq source); raises for a call the kernels refuse."""
    kh, kw = (bias_h.shape[-1], bias_w.shape[-1]) if bias_h is not None \
        else (0, 0)
    if source != "flash_attention_fwd":
        source, entry = "flash_attention_bwd_dq", \
            "vdr_flash_attention_bwd_route"
    else:
        entry = "vdr_flash_attention_route"
    lib, fn = _load(source, [_I] * 5, entry=entry)
    code = fn(_DTYPE_CODES[q.dtype], q.shape[-1], int(bias_h is not None),
              kh, kw)
    if code < 0:
        _raise_on(code, lib, entry[len("vdr_"):])
    return _K6_ROUTES[code]


def flash_attention_fwd(q, k, v, bias_h=None, bias_w=None, kv_len=None, *,
                        scale):
    """K6 forward wrapper: (out, lse), lse (B, H, S) fp32 in log2 units.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/flash_attention_fwd.cu`` (its fp32 build, or in bf16 its Hopper
    or mma.sync body, as :func:`flash_attention_route` says)."""
    kh, kw = _check_flash(q, k, v, bias_h, bias_w, kv_len)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias_h, bias_w, kv_len,
                                         scale=scale)
    b, h, s, d = q.shape
    lib, fn = _k6_entry("flash_attention_fwd", q, d, bias_h, bias_w, k, v,
                        args=[_P] * 8 + [_I] * 6 + [_F, _P])
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, device=q.device, dtype=torch.float32)
    _k6_launch(lib, fn, "flash_attention_fwd", q, _ptr(q), _ptr(k), _ptr(v),
               _ptr(bias_h), _ptr(bias_w), _ptr(_kv_len_i32(kv_len, q)),
               _ptr(out), _ptr(lse), b, h, s, d, kh, kw, scale, _stream(q))
    return out, lse


def flash_attention_bwd_dq(q, k, v, bias_h, bias_w, kv_len, dout, lse, delta,
                           *, scale):
    """K6 dq wrapper: (dq, dbias_h, dbias_w). CPU tensors take the plain
    version; CUDA tensors launch ``csrc/flash_attention_bwd_dq.cu`` (its
    fp32 or bf16 build; the bias gradients fp32 in both)."""
    kh, kw = _check_flash(q, k, v, bias_h, bias_w, kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(
            q, k, v, bias_h, bias_w, kv_len, dout, lse, delta, scale=scale)
    b, h, s, d = q.shape
    lib, fn = _k6_entry("flash_attention_bwd_dq", q, d, bias_h, bias_w, k,
                        v, dout, fp32=(lse, delta),
                        args=[_P] * 12 + [_I] * 6 + [_F, _P])
    dq = torch.empty_like(q)
    dbh = torch.empty_like(bias_h) if bias_h is not None else None
    dbw = torch.empty_like(bias_w) if bias_w is not None else None
    _k6_launch(lib, fn, "flash_attention_bwd_dq", q, _ptr(q), _ptr(k),
               _ptr(v), _ptr(bias_h), _ptr(bias_w),
               _ptr(_kv_len_i32(kv_len, q)), _ptr(dout), _ptr(lse),
               _ptr(delta), _ptr(dq), _ptr(dbh), _ptr(dbw), b, h, s, d, kh,
               kw, scale, _stream(q))
    return dq, dbh, dbw


def flash_attention_bwd_dkv(q, k, v, bias_h, bias_w, kv_len, dout, lse,
                            delta, *, scale):
    """K6 dkv wrapper: (dk, dv). CPU tensors take the plain version; CUDA
    tensors launch ``csrc/flash_attention_bwd_dkv.cu`` (its fp32 or bf16
    build)."""
    kh, kw = _check_flash(q, k, v, bias_h, bias_w, kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(
            q, k, v, bias_h, bias_w, kv_len, dout, lse, delta, scale=scale)
    b, h, s, d = q.shape
    lib, fn = _k6_entry("flash_attention_bwd_dkv", q, d, bias_h, bias_w, k,
                        v, dout, fp32=(lse, delta),
                        args=[_P] * 11 + [_I] * 6 + [_F, _P])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _k6_launch(lib, fn, "flash_attention_bwd_dkv", q, _ptr(q), _ptr(k),
               _ptr(v), _ptr(bias_h), _ptr(bias_w),
               _ptr(_kv_len_i32(kv_len, q)), _ptr(dout), _ptr(lse),
               _ptr(delta), _ptr(dk), _ptr(dv), b, h, s, d, kh, kw, scale,
               _stream(q))
    return dk, dv


def flash_attention_route(q, k, v, bias_h=None, bias_w=None,
                          kv_len=None) -> str:
    """Which body the K6 forward runs for these operands: ``"plain"`` on
    the CPU; on the card, as ``csrc/flash_attention_fwd.cu``'s C entry
    chooses, ``"tiled"`` (fp32: the register-tiled CUDA-core body),
    ``"hopper"`` (bf16 with no bias or a key grid whose width is a multiple
    of 4 from 16 to 128, of at most 128 rows: the TMA + wgmma body) or
    ``"mma"`` (other bf16 grids, Kw 2 mod 4 among them: the mma.sync body).
    Raises for a call the kernels refuse (a head dim other than 64; in
    bf16, a bias grid of more than 320 terms Kh + Kw).
    :func:`flash_attention_bwd_route` answers for the backward, whose
    Hopper bodies take the even widths too."""
    _check_flash(q, k, v, bias_h, bias_w, kv_len)
    if q.device.type == "cpu":
        return "plain"
    _check_bwd_cuda(q, q.shape[-1], k, v, fp32=(bias_h, bias_w),
                    dtype=_K6_DTYPES)
    return _k6_route("flash_attention_fwd", q, bias_h, bias_w)


def flash_attention_bwd_route(q, k, v, bias_h=None, bias_w=None,
                              kv_len=None, *, kernel="dq") -> str:
    """Which body the K6 backward kernel ``kernel`` (``"dq"`` or
    ``"dkv"``) runs for these operands: ``"plain"`` on the CPU; on the card,
    as the dq source's route entry chooses (one choice for both),
    ``"tiled"`` (fp32), ``"hopper"`` (bf16 with no bias or a key grid
    whose width is even from 16 to 128, of at most 128 rows: the TMA +
    wgmma bodies) or ``"mma"`` (other bf16 grids, odd widths and widths
    under 16: the mma.sync bodies). Raises where
    :func:`flash_attention_route` does."""
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel must be 'dq' or 'dkv', got {kernel!r}")
    _check_flash(q, k, v, bias_h, bias_w, kv_len)
    if q.device.type == "cpu":
        return "plain"
    _check_bwd_cuda(q, q.shape[-1], k, v, fp32=(bias_h, bias_w),
                    dtype=_K6_DTYPES)
    return _k6_route(f"flash_attention_bwd_{kernel}", q, bias_h, bias_w)


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias_h, bias_w, num_heads, window_tokens, scale):
        out = fused_window_attention(q, kv, bias_h, bias_w,
                                     num_heads=num_heads,
                                     window_tokens=window_tokens, scale=scale)
        ctx.save_for_backward(q, kv, bias_h, bias_w, out)
        ctx.cfg = (num_heads, window_tokens, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, bias_h, bias_w, out = ctx.saved_tensors
        num_heads, window_tokens, scale = ctx.cfg
        dq, dkv, dbh, dbw = window_attention_bwd(
            q, kv, bias_h, bias_w, out, dout.contiguous(),
            num_heads=num_heads, window_tokens=window_tokens, scale=scale)
        return dq, dkv, dbh, dbw, None, None, None


class _GlobalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias_h, bias_w, kv_len, num_heads, scale):
        out, lse = global_attention_fwd_lse(q, kv, bias_h, bias_w, kv_len,
                                            num_heads=num_heads, scale=scale)
        ctx.save_for_backward(q, kv, bias_h, bias_w, kv_len, out, lse)
        ctx.cfg = (num_heads, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, bias_h, bias_w, kv_len, out, lse = ctx.saved_tensors
        num_heads, scale = ctx.cfg
        dout = dout.contiguous()
        delta = attention_delta(out, dout, num_heads)
        args = (q, kv, bias_h, bias_w, kv_len, dout, lse, delta)
        dq, dbh, dbw = global_attention_bwd_dq(*args, num_heads=num_heads,
                                               scale=scale)
        dkv = global_attention_bwd_dkv(*args, num_heads=num_heads,
                                       scale=scale)
        return dq, dkv, dbh, dbw, None, None, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_h, bias_w, kv_len, scale):
        out, lse = flash_attention_fwd(q, k, v, bias_h, bias_w, kv_len,
                                       scale=scale)
        ctx.save_for_backward(q, k, v, bias_h, bias_w, kv_len, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias_h, bias_w, kv_len, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, k, v, bias_h, bias_w, kv_len, dout, lse,
                flash_attention_delta(out, dout))
        dq, dbh, dbw = flash_attention_bwd_dq(*args, scale=ctx.scale)
        dk, dv = flash_attention_bwd_dkv(*args, scale=ctx.scale)
        return dq, dk, dv, dbh, dbw, None, None


def _scale(q, num_heads, scale):
    return (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale


def window_attention_trainable(q, kv, bias_h=None, bias_w=None, *, num_heads,
                               window_tokens, scale=None):
    """Differentiable block-diagonal window attention (JAX
    ``window_attention_trainable``, ops/attention_grad.py:777).

    q (B, S, H·D), kv (B, S, 2·H·D), optional per-head bias (B, H, S, Kh)
    and (B, H, S, Kw) with Kh·Kw == ``window_tokens``. Returns (B, S, H·D);
    gradients flow to q, kv and both bias factors."""
    return _WindowAttention.apply(q, kv, bias_h, bias_w, num_heads,
                                  window_tokens,
                                  _scale(q, num_heads, scale))


def global_attention_trainable(q, kv, bias_h=None, bias_w=None, kv_len=None,
                               *, num_heads, scale=None):
    """Differentiable global attention (JAX ``global_attention_trainable``,
    ops/attention_grad.py:1581): the same contract as global mode of
    ``flash_attention_fused_qkv`` with per-head bias (Kh·Kw == S) or a
    ``kv_len`` key-padding mask, which is not differentiable."""
    return _GlobalAttention.apply(q, kv, bias_h, bias_w, kv_len, num_heads,
                                  _scale(q, num_heads, scale))


def flash_attention_trainable(q, k, v, bias_h=None, bias_w=None, kv_len=None,
                              *, scale=None):
    """Differentiable flash attention over per-head (B, H, S, D) q, k, v
    (JAX ``flash_attention_trainable``, ops/attention_grad.py:593), K6.

    Optional decomposed bias ``bias_h (B, H, S, Kh)``, ``bias_w (B, H, S,
    Kw)`` with Kh·Kw == S (any Kw), key j taking ``bias_h[..., j // Kw] +
    bias_w[..., j % Kw]``; optional ``kv_len (B,)`` key-padding mask, which
    is not differentiable. q, k, v in fp32 or bf16 (the bias fp32 either
    way). Returns (B, H, S, D) in q's dtype; gradients flow to q, k, v and
    both bias factors."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _FlashAttention.apply(q, k, v, bias_h, bias_w, kv_len, scale)
