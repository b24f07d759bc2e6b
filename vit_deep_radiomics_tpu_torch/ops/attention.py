"""Attention: plain PyTorch reference + the fused window/global CUDA kernels.

Counterpart of ``vit_deep_radiomics_tpu/ops/attention.py``:

* :func:`attention_reference` — plain einsum attention with an optional
  additive bias and key-padding mask; the parity oracle.
* :func:`flash_attention_fused_qkv` — attention read straight from the
  split QKV projection (q ``(B, S, H·D)``, kv ``(B, S, 2·H·D)``), output in
  projection-ready ``(B, S, H·D)`` layout, with SAM's decomposed
  relative-position bias given per head as ``bias_h (B, H, S, Kh)`` and
  ``bias_w (B, H, S, Kw)``. Two modes, two kernels:

  - **window** (``window_tokens`` set): the token axis is a concatenation
    of independent windows; kernel K1, ``csrc/fused_window_attention.cu``.
  - **global**: one attention over all S tokens, with the bias
    (``Kh·Kw == S``) or a ``kv_len`` padding mask; kernel K2,
    ``csrc/fused_global_attention.cu``.

* :func:`flash_attention` — generic head-major ``(B, H, S, D)`` flash
  attention, kernel K3 (``csrc/flash_attention.cu``), the backbone's path
  for the grids and head layouts the fused kernels refuse: the decomposed
  bias (``Sk == Kh·Kw``), ``kv_grid`` validity on a padded key grid,
  ``window_tokens`` block-diagonal attention and ``kv_len``.

For a CUDA tensor the wrappers launch their kernel or raise; for a CPU
tensor they run the plain version of the same function
(:func:`fused_window_attention_plain`, :func:`fused_global_attention_plain`,
:func:`flash_attention_plain`). Each wrapper counts its launches in
:data:`LAUNCHES` (``ops/_kernels.py``), which also holds the counters of
the kernels in ``ops/attention_grad.py``, ``ops/mlp_fused.py`` (K7) and
``ops/quant.py`` (K8).

Unlike the JAX kernels (nomax softmax by default, bf16 score chains on bf16
inputs), the kernels keep the running max and fp32 scores: the same
function, with the tolerances stated in the tests.
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import (LAUNCHES, _DTYPE_CODES, _F, _I, _P, _load, _ptr,
                       register_launches, reset_launch_counts)

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "attention_reference",
    "flash_attention_fused_qkv",
    "fused_window_attention",
    "fused_window_attention_plain",
    "fused_window_attention_route",
    "fused_global_attention",
    "fused_global_attention_plain",
    "fused_global_attention_route",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_route",
]

_NEG_INF = -1e30  # large-negative instead of -inf: fully-masked rows stay finite

register_launches("fused_window_attention", "fused_global_attention",
                  "flash_attention")

# the one head dim the fused and trainable kernels build: every config of
# the repo has D = 64
_KERNEL_HEAD_DIM = 64
# the head dims K3 (csrc/flash_attention.cu) builds, template instances
_K3_HEAD_DIMS = (32, 64, 128)


def attention_reference(q, k, v, bias=None, kv_len=None, scale=None):
    """Plain attention. q, k, v: (B, H, S, D); bias broadcastable to
    (B, H, Sq, Sk); kv_len: (B,) valid key counts.

    Products are taken in fp32 from the inputs' values (as the JAX oracle's
    fp32-accumulated dots do); the probabilities are rounded to v's dtype
    before the PV product, as in JAX."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if kv_len is not None:
        kidx = torch.arange(k.shape[2], device=k.device)
        mask = kidx[None, None, None, :] < kv_len[:, None, None, None]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _head_group(num_heads: int, head_dim: int) -> int | None:
    """Heads per 128-lane group, or None (JAX ops/attention.py:435).

    The port's kernels do not need 128-lane groups; the function is kept so
    that the port accepts and refuses exactly the head layouts the JAX
    fused kernels do, and ``WindowedAttention._fused_variant`` selects the
    same mode."""
    if head_dim % 128 == 0:
        return 1
    if 128 % head_dim == 0:
        pair = 128 // head_dim
        if num_heads % (2 * pair) == 0:
            return 2 * pair
        if num_heads % pair == 0:
            return pair
    return None


def _heads(x, nseg, seg, num_heads):
    """(B, nseg·seg, H·D) → (B·nseg, H, seg, D)."""
    b = x.shape[0]
    return x.reshape(b * nseg, seg, num_heads, -1).transpose(1, 2)


def _plain(q, kv, bias_h, bias_w, kv_len, num_heads, seg, scale):
    b, s, c = q.shape
    nseg = s // seg
    qh = _heads(q, nseg, seg, num_heads)
    kh_ = _heads(kv[..., :c], nseg, seg, num_heads)
    vh = _heads(kv[..., c:], nseg, seg, num_heads)
    dense = None
    if bias_h is not None:
        def per_seg(t):   # (B, H, nseg·seg, K) → (B·nseg, H, seg, K)
            k = t.shape[-1]
            return t.reshape(b, num_heads, nseg, seg, k).transpose(1, 2) \
                .reshape(b * nseg, num_heads, seg, k).float()
        bh, bw = per_seg(bias_h), per_seg(bias_w)
        dense = (bh[..., :, None] + bw[..., None, :]).reshape(
            b * nseg, num_heads, seg, seg)
    out = attention_reference(qh, kh_, vh, bias=dense, kv_len=kv_len,
                              scale=scale)
    return out.transpose(1, 2).reshape(b, s, c)


def fused_window_attention_plain(q, kv, bias_h, bias_w, *, num_heads,
                                 window_tokens, scale):
    """Plain PyTorch version of K1: dense per-window scores, bias built
    from ``bias_h``/``bias_w``, softmax, PV."""
    return _plain(q, kv, bias_h, bias_w, None, num_heads, window_tokens,
                  scale)


def fused_global_attention_plain(q, kv, bias_h, bias_w, kv_len, *,
                                 num_heads, scale):
    """Plain PyTorch version of K2: dense scores over all S keys, optional
    decomposed bias and ``kv_len`` mask, softmax, PV."""
    return _plain(q, kv, bias_h, bias_w, kv_len, num_heads, q.shape[1],
                  scale)


def _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, window_tokens):
    """Every shape and bias check of both modes, with the ValueErrors of
    JAX ``flash_attention_fused_qkv`` (ops/attention.py:933-1084);
    ``window_tokens`` None is global mode. Returns (D, Kh, Kw)."""
    b, s, c = q.shape
    if tuple(kv.shape) != (b, s, 2 * c):
        raise ValueError(f"kv shape {tuple(kv.shape)} != ({b}, {s}, {2 * c})")
    if (3 * c) % (3 * num_heads):
        raise ValueError(f"qkv width {3 * c} != 3·H·D for H={num_heads}")
    d = c // num_heads
    if _head_group(num_heads, d) is None:
        raise ValueError(
            f"head layout H={num_heads}, D={d} does not tile into 128-lane "
            "blocks")
    if (bias_h is None) != (bias_w is None):
        raise ValueError("bias_h and bias_w must be given together")
    kh = kw = 0
    if bias_h is not None:
        kh, kw = bias_h.shape[-1], bias_w.shape[-1]
        if tuple(bias_h.shape) != (b, num_heads, s, kh) or \
                tuple(bias_w.shape) != (b, num_heads, s, kw):
            raise ValueError(
                f"bias shapes {tuple(bias_h.shape)}, {tuple(bias_w.shape)} "
                f"!= ({b}, {num_heads}, {s}, K)")
    if window_tokens is not None:
        if s % window_tokens:
            raise ValueError(
                f"window_tokens {window_tokens} must divide block {s}"
                f" and block must divide seq {s}")
        if bias_h is not None and kh * kw != window_tokens:
            raise ValueError(
                f"per-window bias grid {kh}x{kw} != window_tokens "
                f"{window_tokens}")
    else:
        if bias_h is not None and kh * kw != s:
            raise ValueError(f"Kh*Kw = {kh}*{kw} != S = {s}")
        if kv_len is not None and tuple(kv_len.shape) != (b,):
            raise ValueError(f"kv_len shape {tuple(kv_len.shape)} != ({b},)")
    return d, kh, kw


def _check_cuda(q, d, *tensors, builds=(_KERNEL_HEAD_DIM,),
                source="csrc/*.cu"):
    """What a kernel launch needs beyond the layout: a dtype and head dim
    with a build, and operands on q's device, in q's dtype, contiguous and
    16-byte aligned."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in builds:
        raise ValueError(f"no kernel build for head dim {d}; {source} "
                         f"build D={'/'.join(map(str, builds))} only")
    for t in (q, *tensors):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"operand dtype {t.dtype} != q dtype {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte "
                             "aligned")


def _raise_on(rc: int, lib, name: str) -> None:
    if rc == -1:
        raise ValueError(f"{name}: head dim has no kernel build "
                         f"(D={_KERNEL_HEAD_DIM} only)")
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.vdr_error_string(rc).decode()}")


def fused_window_attention(q, kv, bias_h=None, bias_w=None, *, num_heads,
                           window_tokens, scale):
    """K1 wrapper. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fused_window_attention.cu`` on the current stream."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, None, num_heads,
                              window_tokens)
    if q.device.type == "cpu":
        return fused_window_attention_plain(
            q, kv, bias_h, bias_w, num_heads=num_heads,
            window_tokens=window_tokens, scale=scale)
    _check_cuda(q, d, kv, bias_h, bias_w)
    b, s, _ = q.shape
    lib, fn = _load("fused_window_attention",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                     _P])
    out = torch.empty_like(q)
    rc = fn(_ptr(q), _ptr(kv), _ptr(bias_h), _ptr(bias_w), _ptr(out),
            b, s, num_heads, d, window_tokens, kh, kw, scale,
            _DTYPE_CODES[q.dtype],
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(rc, lib, "fused_window_attention")
    LAUNCHES["fused_window_attention"] += 1
    return out


def fused_window_attention_route(q, kv, bias_h=None, bias_w=None, *,
                                 num_heads, window_tokens, scale) -> str:
    """Which body :func:`fused_window_attention` runs for these operands:
    ``"plain"`` on the CPU; on the card, as ``csrc/fused_window_attention.cu``
    chooses, ``"tiled"`` (fp32: the register-tiled forward of
    ``f32_tiled_forward.cuh``), ``"hopper"`` (the TMA + wgmma kernel: bf16,
    windows of at most 256 tokens, Kh + Kw at most 47, 1/scale a power of
    two) or ``"loops"`` (bf16 otherwise: the
    mma.sync loop of ``flash_attention_core.cuh``)."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, None, num_heads,
                              window_tokens)
    if q.device.type == "cpu":
        return "plain"
    _check_cuda(q, d, kv, bias_h, bias_w)
    _, fn = _load("fused_window_attention", [_I] * 7 + [_F, _I],
                  entry="vdr_fused_window_route")
    return ("loops", "hopper", "tiled")[
        fn(q.shape[1], num_heads, d, window_tokens, kh, kw,
           int(bias_h is not None), scale, _DTYPE_CODES[q.dtype])]


def fused_global_attention(q, kv, bias_h=None, bias_w=None, kv_len=None, *,
                           num_heads, scale):
    """K2 wrapper. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fused_global_attention.cu`` on the current stream."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, None)
    if q.device.type == "cpu":
        return fused_global_attention_plain(
            q, kv, bias_h, bias_w, kv_len, num_heads=num_heads, scale=scale)
    _check_cuda(q, d, kv, bias_h, bias_w)
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    b, s, _ = q.shape
    lib, fn = _load("fused_global_attention",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                     _P])
    out = torch.empty_like(q)
    rc = fn(_ptr(q), _ptr(kv), _ptr(bias_h), _ptr(bias_w), _ptr(kv_len),
            _ptr(out), b, s, num_heads, d, kh, kw, scale,
            _DTYPE_CODES[q.dtype],
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(rc, lib, "fused_global_attention")
    LAUNCHES["fused_global_attention"] += 1
    return out


def fused_global_attention_route(q, kv, bias_h=None, bias_w=None,
                                 kv_len=None, *, num_heads, scale) -> str:
    """Which body :func:`fused_global_attention` runs for these operands:
    ``"plain"`` on the CPU; on the card, as ``csrc/fused_global_attention.cu``
    chooses, ``"tiled"`` (fp32: the register-tiled forward of
    ``f32_tiled_forward.cuh``), ``"hopper"`` (bf16 with no bias or Kw 64 or
    128: the TMA + wgmma kernel) or ``"loops"`` (bf16 otherwise: the
    mma.sync loop of ``flash_attention_core.cuh``)."""
    d, kh, kw = _check_layout(q, kv, bias_h, bias_w, kv_len, num_heads, None)
    if q.device.type == "cpu":
        return "plain"
    _check_cuda(q, d, kv, bias_h, bias_w)
    _, fn = _load("fused_global_attention", [_I] * 4,
                  entry="vdr_fused_global_route")
    return ("loops", "hopper", "tiled")[
        fn(kh, kw, int(bias_h is not None), _DTYPE_CODES[q.dtype])]


def flash_attention_fused_qkv(q, kv, bias_h=None, bias_w=None, kv_len=None,
                              *, num_heads, window_tokens=None, scale=None):
    """Attention straight from the split QKV projection.

    Args:
        q: (B, S, H·D) query section of the projection.
        kv: (B, S, 2·H·D), columns [k · H heads | v · H heads].
        bias_h, bias_w: optional per-head decomposed rel-pos terms
            (B, H, S, Kh) and (B, H, S, Kw). Key j takes
            ``bias_h[..., j // Kw] + bias_w[..., j % Kw]``; ``Kh·Kw`` must
            equal ``window_tokens`` (window mode) or S (global mode).
        kv_len: optional (B,) valid key counts (global mode only).
        num_heads: H.
        window_tokens: window mode — the token axis is a concatenation of
            windows of this many tokens, each attended independently.
        scale: score scale, default D^-1/2.

    Returns:
        (B, S, H·D) attention output in q's dtype.

    The layout checks live in the two wrappers (:func:`_check_layout`).
    """
    scale = (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale
    if window_tokens:
        if kv_len is not None:
            raise ValueError("kv_len is not supported in window mode")
        return fused_window_attention(
            q, kv, bias_h, bias_w, num_heads=num_heads,
            window_tokens=window_tokens, scale=scale)
    return fused_global_attention(q, kv, bias_h, bias_w, kv_len,
                                  num_heads=num_heads, scale=scale)


def _check_flash_layout(q, k, v, bias_h, bias_w, kv_len, kv_grid,
                        window_tokens, block_q, block_k):
    """The ValueErrors of JAX ``flash_attention`` (ops/attention.py:
    265-318), in its order; ``block_q``/``block_k`` are TPU tilings whose
    divisibility rules JAX raises on. Plus shape checks and one refusal of
    the port's own: a ``kv_grid`` that keeps no key."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"!= ({b}, {h}, Sk, {d})")
    has_bias = bias_h is not None
    if has_bias != (bias_w is not None):
        raise ValueError("bias_h and bias_w must be given together")
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lens ({sq}, {sk}) must divide blocks "
                         f"({block_q}, {block_k})")
    if kv_grid is not None and not has_bias:
        raise ValueError("kv_grid requires bias_h/bias_w (they set Kw)")
    kh = kw = 0
    if has_bias:
        kh, kw = bias_h.shape[-1], bias_w.shape[-1]
        if tuple(bias_h.shape) != (b, h, sq, kh) or \
                tuple(bias_w.shape) != (b, h, sq, kw):
            raise ValueError(
                f"bias shapes {tuple(bias_h.shape)}, {tuple(bias_w.shape)} "
                f"!= ({b}, {h}, {sq}, K)")
        if not window_tokens and kh * kw != sk:
            raise ValueError(f"Kh*Kw = {kh}*{kw} != Sk = {sk}")
    if window_tokens:
        if kv_grid is None:
            raise ValueError("window_tokens requires kv_grid")
        if sq != sk:
            raise ValueError("window_tokens requires Sq == Sk")
        if kv_len is not None:
            raise ValueError(
                "kv_len is not supported in window mode; express validity "
                "via the kv_grid (kh_valid, kw_valid) sub-grid instead")
        if block_q % window_tokens or sq % block_q:
            raise ValueError(
                f"window_tokens {window_tokens} must divide block {block_q}"
                f" and block must divide seq {sq}")
        if kh * kw != window_tokens:
            raise ValueError(
                f"block-diagonal bias grid {kh}x{kw} must equal "
                f"window_tokens = {window_tokens} (per-window bias layout)")
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len shape {tuple(kv_len.shape)} != ({b},)")
    if kv_grid is not None and min(kv_grid) < 1:
        raise ValueError(f"kv_grid {tuple(kv_grid)} keeps no key")
    return d, kh, kw


def flash_attention_plain(q, k, v, bias_h=None, bias_w=None, kv_len=None,
                          *, kv_grid=None, window_tokens=None, scale):
    """Plain PyTorch version of K3: dense fp32 scores from the inputs'
    values, the decomposed bias, the masks (-1e30, as JAX), softmax, the
    probabilities rounded to v's dtype for the PV product. Window mode runs
    each window on its own."""
    b, h, sq, d = q.shape
    if window_tokens:
        n = sq // window_tokens

        def win(t):
            return None if t is None else t.reshape(
                b, h, n, window_tokens, t.shape[-1])

        q, k, v, bias_h, bias_w = map(win, (q, k, v, bias_h, bias_w))
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    key = torch.arange(s.shape[-1], device=q.device)
    valid = torch.ones_like(key, dtype=torch.bool)
    if bias_h is not None:
        kw = bias_w.shape[-1]
        s = s + (bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
                 ).reshape(s.shape)
        if kv_grid is not None:
            valid = (key // kw < kv_grid[0]) & (key % kw < kv_grid[1])
    if kv_len is not None:
        valid = valid & (key[None, :] < kv_len.to(q.device)[:, None])
        valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...qk,...kd->...qd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_route(q, k, v, bias_h=None, bias_w=None, kv_len=None,
                          *, kv_grid=None, window_tokens=None, scale=None,
                          block_q=512, block_k=512) -> str:
    """Which body :func:`flash_attention` runs for these operands:
    ``"plain"`` on the CPU; on the card, as ``csrc/flash_attention.cu``
    chooses, ``"tiled"`` (fp32 at D 64, window mode too: the
    register-tiled forward of ``f32_tiled_forward.cuh``), ``"hopper"``
    (bf16 at D 64 outside window mode with no bias, or a bias on key-grid
    rows of 64 keys whose valid columns round up to 48 or 64 and no
    ``kv_len``: the TMA + wgmma kernel), ``"hopper_window"`` (bf16 at D 64
    in window mode, windows of at most 256 tokens, Kh + Kw at most 47 and
    1/scale a power of two: K1's whole-window body of
    ``window_hopper.cuh``) or ``"loops"`` (the loops of
    ``flash_attention.cu``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    d, kh, kw = _check_flash_layout(q, k, v, bias_h, bias_w, kv_len,
                                    kv_grid, window_tokens, block_q, block_k)
    if q.device.type == "cpu":
        return "plain"
    _check_cuda(q, d, k, v, bias_h, bias_w, builds=_K3_HEAD_DIMS,
                source="csrc/flash_attention.cu")
    _, fn = _load("flash_attention", [_I] * 9 + [_F],
                  entry="vdr_flash_attention_route")
    kh_valid, kw_valid = kv_grid if kv_grid is not None else (0, 0)
    return ("loops", "hopper", "tiled", "hopper_window")[
        fn(d, window_tokens or 0, _DTYPE_CODES[q.dtype],
           int(bias_h is not None), int(kv_len is not None), kh, kw,
           kh_valid, kw_valid, scale)]


def flash_attention(q, k, v, bias_h=None, bias_w=None, kv_len=None, *,
                    kv_grid=None, window_tokens=None, scale=None,
                    block_q=512, block_k=512):
    """Flash attention over head-major (B, H, S, D), K3.

    Args:
        q, k, v: (B, H, Sq, D) / (B, H, Sk, D).
        bias_h, bias_w: optional decomposed rel-pos terms (B, H, Sq, Kh)
            and (B, H, Sq, Kw); key j takes ``bias_h[..., j // Kw] +
            bias_w[..., j % Kw]`` (window mode: of ``j % window_tokens``).
            ``Sk == Kh·Kw`` outside window mode.
        kv_len: optional (B,) valid key counts.
        kv_grid: optional (kh_valid, kw_valid): only that top-left
            sub-grid of the padded (Sk // Kw, Kw) key grid is real (window
            mode: of each window's grid). Needs the bias.
        window_tokens: block-diagonal mode, q/k a concatenation of windows
            of this many tokens; needs ``kv_grid`` and Sq == Sk, refuses
            ``kv_len``.
        scale: score scale, default D^-1/2.
        block_q, block_k: JAX's TPU tiles; only its divisibility rules are
            checked.

    Masked scores are -1e30, so a row with no valid key averages V over
    the keys it was given, as JAX's does. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch
    ``csrc/flash_attention.cu`` (D in 32, 64, 128) on the current stream,
    on the body :func:`flash_attention_route` names.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    d, kh, kw = _check_flash_layout(q, k, v, bias_h, bias_w, kv_len, kv_grid,
                                    window_tokens, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias_h, bias_w, kv_len,
                                     kv_grid=kv_grid,
                                     window_tokens=window_tokens,
                                     scale=scale)
    _check_cuda(q, d, k, v, bias_h, bias_w, builds=_K3_HEAD_DIMS,
                source="csrc/flash_attention.cu")
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    b, h, sq, _ = q.shape
    lib, fn = _load("flash_attention",
                    [_P] * 7 + [_I] * 10 + [_F, _I, _P])
    out = torch.empty_like(q)
    kh_valid, kw_valid = kv_grid if kv_grid is not None else (0, 0)
    rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias_h), _ptr(bias_w),
            _ptr(kv_len), _ptr(out), b, h, sq, k.shape[2], d, kh, kw,
            kh_valid, kw_valid, window_tokens or 0, scale,
            _DTYPE_CODES[q.dtype],
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc:
        raise RuntimeError("flash_attention launch failed: "
                           f"{lib.vdr_error_string(rc).decode()}")
    LAUNCHES["flash_attention"] += 1
    return out
