"""Fused LayerNorm → MLP → residual (the ``VDR_FUSED_MLP=1`` inference path).

Counterpart of ``vit_deep_radiomics_tpu/ops/mlp_fused.py``: the second
half of a ViT block, ``x + ls·(gelu_tanh(LN(x)·w1 + b1)·w2 + b2)``, with
the (rows, H) hidden activation kept on the chip (kernel K7,
``csrc/fused_ln_mlp_residual.cu``). The cast points are JAX's:

1. fp32 LayerNorm statistics, ``y`` rounded to x's dtype;
2. ``h = y·w1`` with an fp32 accumulator, ``+ b1`` in fp32;
3. tanh GELU in fp32, rounded to x's dtype;
4. ``g·w2`` accumulated in fp32, ``+ b2``, rounded to x's dtype;
5. ``× layerscale`` in x's dtype;
6. ``x +`` in x's dtype.

Weights keep JAX's layout at this function, w1 (C, H) and w2 (H, C); the
transposed view of a torch ``Linear`` weight is what the kernel reads, so
the model passes ``lin1.weight.t()`` at no cost. For a CPU tensor
:func:`fused_ln_mlp_residual` runs :func:`fused_ln_mlp_residual_plain`; for
a CUDA tensor it launches K7 (C in 384, 768, 1024 in bf16, the path, or
fp32; C 1536, DINOv2 ViT-g/14, in bf16) or raises.
:func:`fused_ln_mlp_residual_route` says which body a call takes: bf16 at
C 768 with a hidden width that is a multiple of 128 (SAM ViT-B/16, DINOv2
ViT-B/14) the Hopper body (TMA + wgmma), every other call the first
version's loops (at C 1536 their instance of 32-row blocks and 16-unit
hidden chunks).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._kernels import _DTYPE_CODES, LAUNCHES, _load, _ptr, register_launches

__all__ = ["fused_ln_mlp_residual", "fused_ln_mlp_residual_plain",
           "fused_ln_mlp_residual_route"]

register_launches("fused_ln_mlp_residual")

# the widths K7 builds (template instances), per dtype, and the hidden-chunk
# width of each loop instance (the Hopper body takes bf16 at C 768 with
# hidden % 128 == 0)
_CHUNK = {torch.bfloat16: {384: 32, 768: 32, 1024: 32, 1536: 16},
          torch.float32: {384: 16, 768: 16, 1024: 16}}
_ROUTES = ("loops", "hopper")


def fused_ln_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                layerscale=None, *, eps: float = 1e-6):
    """Plain PyTorch version of K7: the unfused modules' computation
    (``models/vit.py`` ``LayerNorm`` + ``Mlp`` + residual), products in
    fp32 from the dtype-rounded operands."""
    dt = x.dtype
    y = F.layer_norm(x.float(), (x.shape[-1],), ln_scale.float(),
                     ln_bias.float(), eps).to(dt)
    h = torch.matmul(y.float(), w1.to(dt).float()) + b1.float()
    g = F.gelu(h, approximate="tanh").to(dt)
    o = (torch.matmul(g.float(), w2.to(dt).float()) + b2.float()).to(dt)
    if layerscale is not None:
        o = o * layerscale.to(dt)
    return x + o


def _check_shapes(x, ln_scale, ln_bias, w1, b1, w2, b2, layerscale):
    c = x.shape[-1]
    hidden = w1.shape[-1]
    want = {"ln_scale": (ln_scale, (c,)), "ln_bias": (ln_bias, (c,)),
            "w1": (w1, (c, hidden)), "b1": (b1, (hidden,)),
            "w2": (w2, (hidden, c)), "b2": (b2, (c,))}
    if layerscale is not None:
        want["layerscale"] = (layerscale, (c,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    return c, hidden


def _check_cuda(x, c, hidden):
    """What K7 refuses before any launch: a dtype, a width or a hidden
    width it has no body for."""
    dt = x.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"K7 takes float32 or bfloat16, got {dt}")
    chunks = _CHUNK[dt]
    if c not in chunks:
        raise ValueError(f"no K7 build for width {c} in {dt}; "
                         f"csrc/fused_ln_mlp_residual.cu builds C="
                         f"{'/'.join(map(str, chunks))} only")
    if hidden % chunks[c]:
        raise ValueError(f"K7 needs the hidden width {hidden} to be a "
                         f"multiple of {chunks[c]} for {dt} at C {c}")


def fused_ln_mlp_residual_route(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                layerscale=None) -> str:
    """Which body :func:`fused_ln_mlp_residual` runs for these operands:
    ``"plain"`` on the CPU; on the card, as ``csrc/fused_ln_mlp_residual.cu``
    chooses, ``"hopper"`` (bf16, C 768, hidden a multiple of 128) or
    ``"loops"``. Raises for a call K7 refuses."""
    c, hidden = _check_shapes(x, ln_scale, ln_bias, w1, b1, w2, b2,
                              layerscale)
    if x.device.type == "cpu":
        return "plain"
    _check_cuda(x, c, hidden)
    _, fn = _load("fused_ln_mlp_residual", [ctypes.c_int] * 3,
                  entry="vdr_fused_ln_mlp_residual_route")
    return _ROUTES[fn(c, hidden, _DTYPE_CODES[x.dtype])]


def fused_ln_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2,
                          layerscale=None, *, eps: float = 1e-6):
    """``x + ls·(gelu_tanh(LN(x)·w1 + b1)·w2 + b2)`` over the last axis of
    x (any leading shape, any number of rows), K7. Weights are cast to
    x's dtype and LN parameters and biases to fp32, as the unfused path
    does."""
    c, hidden = _check_shapes(x, ln_scale, ln_bias, w1, b1, w2, b2,
                              layerscale)
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2,
                                           b2, layerscale, eps=eps)
    _check_cuda(x, c, hidden)
    dt = x.dtype
    x2 = x.reshape(-1, c).contiguous()
    dev = x2.device

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    ops = [x2, f32(ln_scale), f32(ln_bias), w1.t().to(dt).contiguous(),
           f32(b1), w2.t().to(dt).contiguous(), f32(b2),
           None if layerscale is None else layerscale.to(dt).contiguous()]
    for t in ops:
        if t is not None and (t.device != dev or t.data_ptr() % 16):
            raise ValueError("K7 operands must lie on x's device, 16-byte "
                             "aligned")
    lib, fn = _load("fused_ln_mlp_residual",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(x2)
    rc = fn(*map(_ptr, ops), _ptr(out), x2.shape[0], c, hidden, eps,
            _DTYPE_CODES[dt],
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc:
        raise RuntimeError("fused_ln_mlp_residual launch failed: "
                           f"{lib.vdr_error_string(rc).decode()}")
    LAUNCHES["fused_ln_mlp_residual"] += 1
    return out.reshape(x.shape)
