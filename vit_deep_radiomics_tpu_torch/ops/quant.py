"""Dynamic int8 matmuls for the frozen-backbone inference path, and K8.

Counterpart of ``vit_deep_radiomics_tpu/ops/quant.py``. The ``int8``
precision policy quantizes the backbone's five per-block matmuls (the q,
kv and output projections and the two MLP layers):

* weights: symmetric per-output-channel scales ``max|w| / 127`` over the
  contraction axis, requantized per call;
* activations: dynamic symmetric per-row scales;
* the contraction s8×s8→s32, exact, then one rescale
  ``y.float() * (s_x * s_w)`` (JAX's order), the bias added by the caller
  in fp32.

:func:`quantize_rows`, :func:`quantize_weight`, :func:`int8_dot` and
:func:`int8_dot_prequant` are plain torch, as they are XLA ops in JAX, and
compute the same IEEE operations (round half to even, clip to ±127). The
contraction is kernel K8, ``csrc/int8_matmul.cu``: :func:`int8_matmul`
keeps JAX ``int8_matmul_pallas``'s contract ((M, K) @ (K, N) int8 → int32,
every dimension a multiple of 128), :func:`int8_matmul_nk` takes the weight
in the (N, K) layout that ``quantize_weight`` gives a torch ``Linear``
weight. For a CPU tensor the wrappers take :func:`int8_matmul_plain`; for
a CUDA tensor they launch K8 or raise. On CUDA, :func:`int8_dot_prequant`
pads the rows with zeros to a multiple of 128 for K8 and cuts the result
back.

:func:`warn_if_int8_emulated` keeps JAX's guard against an int8 path that
is slower than bf16, probing the port's own int8 path (K8) against the
bf16 ``torch.matmul``; :func:`int8_kernel_rate_ratio` is the counterpart
of ``int8_pallas_rate_ratio``: K8 against ``torch._int_mm`` and the bf16
matmul at one backbone shape.
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from ._kernels import LAUNCHES, _load, _ptr, register_launches

__all__ = [
    "quantize_rows", "quantize_weight", "int8_dot", "int8_dot_prequant",
    "int8_matmul", "int8_matmul_nk", "int8_matmul_plain",
    "int8_matmul_rate_ratio", "warn_if_int8_emulated",
    "int8_kernel_rate_ratio",
]

# smallest row scale: all-zero rows (window padding) quantize to 0 and
# rescale to exactly 0
_EPS = 1e-12
_TILE = 128    # every dimension of a K8 call is a multiple of this

register_launches("int8_matmul")


def _quantize(x, dim: int):
    xf = x.float()
    # divide by a tensor: a CUDA division by a Python scalar multiplies by
    # its reciprocal, which moves the last bit of the scale, and then a
    # quantized value, away from JAX's
    s = torch.clamp_min(xf.abs().amax(dim=dim, keepdim=True)
                        / xf.new_tensor(127.0), _EPS)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rows(x):
    """Per-row symmetric int8 quantization of the trailing axis: ``(x_q
    int8, s_x fp32)`` with ``s_x`` keepdims, ``x ≈ x_q * s_x``."""
    return _quantize(x, -1)


def quantize_weight(w, contract_axis: int = 0):
    """Per-output-channel symmetric int8 quantization of a 2-D weight;
    the scales run over ``contract_axis``, so a (K, N) weight (axis 0)
    gets (1, N) scales and a torch (N, K) weight (axis 1) (N, 1)."""
    return _quantize(w, contract_axis)


def int8_dot(x, w):
    """``x @ w`` for (..., K) activations and a (K, N) float weight through
    dynamic int8; fp32 output, rescaled by ``s_x · s_w``."""
    return int8_dot_prequant(quantize_rows(x), w)


def int8_dot_prequant(x_qs, w):
    """:func:`int8_dot` with a pre-quantized ``(x_q, s_x)`` pair, so one
    quantization can feed several matmuls (the split q/kv projections).
    ``w`` is (K, N); a transposed view of a torch (N, K) weight costs no
    copy on the kernel path."""
    x_q, s_x = x_qs
    w_q, s_w = quantize_weight(w, contract_axis=0)
    k = x_q.shape[-1]
    x2 = x_q.reshape(-1, k)
    m = x2.shape[0]
    if x2.device.type == "cpu":
        y = int8_matmul_plain(x2, w_q)
    else:
        pad = (-m) % _TILE
        if pad:
            x2 = F.pad(x2, (0, 0, 0, pad))
        y = int8_matmul_nk(x2, w_q.t().contiguous())[:m]
    y = y.reshape(*x_q.shape[:-1], w_q.shape[1])
    return y.float() * (s_x * s_w)


def int8_matmul_plain(x_q, w_q):
    """Plain version of K8: (M, K) @ (K, N) int8 → int32, exact. On the
    card in float64 (|acc| ≤ 127²·K < 2⁵³ for any K below 5·10¹¹), on the
    CPU in int64."""
    if x_q.device.type == "cpu":
        return (x_q.long() @ w_q.long()).int()
    return (x_q.double() @ w_q.double()).int()


def _check_tiling(m: int, k: int, n: int) -> None:
    """JAX ``int8_matmul_pallas``'s ``fit``: each dimension needs a
    128-multiple tile that divides it."""
    if any(d < _TILE or d % _TILE for d in (m, k, n)):
        raise ValueError(
            f"shape ({m},{k})@({k},{n}) has no 128-multiple tiling")


def int8_matmul(x_q, w_q):
    """K8 with JAX ``int8_matmul_pallas``'s contract: (M, K) int8 @ (K, N)
    int8 → (M, N) int32, exact; ``ValueError`` unless M, K and N are
    multiples of 128 (callers pad)."""
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    _check_tiling(m, k, n)
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q)
    return int8_matmul_nk(x_q, w_q.t().contiguous())


def int8_matmul_nk(x_q, w_nk):
    """K8 on an (N, K) weight, the layout of a torch ``Linear`` weight and
    the column operand of the s8 tensor-core product: (M, K) @ (N, K)ᵀ →
    (M, N) int32. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/int8_matmul.cu`` on the current stream or raise."""
    m, k = x_q.shape
    n, k2 = w_nk.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    _check_tiling(m, k, n)
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_nk.t())
    for t in (x_q, w_nk):
        if t.dtype != torch.int8:
            raise TypeError(f"K8 takes int8 operands, got {t.dtype}")
        if t.device != x_q.device:
            raise ValueError(f"operand on {t.device}, x_q on {x_q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte "
                             "aligned")
    lib, fn = _load("int8_matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    out = torch.empty(m, n, dtype=torch.int32, device=x_q.device)
    rc = fn(_ptr(x_q), _ptr(w_nk), _ptr(out), m, n, k, ctypes.c_void_p(
        torch.cuda.current_stream(x_q.device).cuda_stream))
    if rc:
        raise RuntimeError("int8_matmul launch failed: "
                           f"{lib.vdr_error_string(rc).decode()}")
    LAUNCHES["int8_matmul"] += 1
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _int8_operands(m: int, k: int, n: int, dev, chain: int = 1):
    """JAX's probe operands (numpy seed 0): x (m, k) and ``chain`` weights
    (n, k), int8 in [-127, 127)."""
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(-127, 127, size=(m, k)).astype(
        np.int8)).to(dev)
    w8 = torch.from_numpy(rng.integers(-127, 127, size=(chain, n, k))
                          .astype(np.int8)).to(dev)
    return x8, w8


def _seconds(fn, reps: int, dev) -> float:
    fn()                                   # build, warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def int8_matmul_rate_ratio(m: int = 4096, k: int = 768, n: int = 3072,
                           reps: int = 20, device=None) -> float:
    """bf16 time over int8 time of one (m, k) @ (k, n) product on
    ``device`` (the card unless the caller names one): the port's int8
    contraction (K8, or its plain version on the CPU) against the bf16
    ``torch.matmul``. Below 1 int8 is slower."""
    dev = default_device(device)
    x8, w8 = _int8_operands(m, k, n, dev)
    w8 = w8[0]
    xb, wb = x8.to(torch.bfloat16), w8.t().to(torch.bfloat16)
    t_int8 = _seconds(lambda: int8_matmul_nk(x8, w8), reps, dev)
    t_bf16 = _seconds(lambda: torch.matmul(xb, wb), reps, dev)
    return t_bf16 / t_int8


def warn_if_int8_emulated(log=None, threshold: float = 0.5,
                          benefit_threshold: float = 1.15,
                          device=None) -> float:
    """Guard ``--precision int8`` with a live measurement
    (:func:`int8_matmul_rate_ratio`): below ``threshold`` this raises
    unless ``VDR_ALLOW_INT8=1``, so an extraction cannot silently run at a
    fraction of the bf16 throughput; below ``benefit_threshold`` it warns
    that int8 buys no speed while it still pays its quantization error.
    Returns the measured ratio."""
    ratio = int8_matmul_rate_ratio(device=device)
    if ratio < threshold:
        msg = (
            f"int8 matmuls run at {ratio:.2f}x the bf16 rate on this "
            "device (measured just now): --precision int8 would SLOW "
            "extraction down.  Set VDR_ALLOW_INT8=1 to run anyway."
        )
        if os.environ.get("VDR_ALLOW_INT8", "0") != "1":
            raise RuntimeError(msg)
        (log or print)(f"WARNING: {msg}")
    elif ratio < benefit_threshold:
        (log or print)(
            f"WARNING: measured int8/bf16 matmul rate ratio is "
            f"{ratio:.2f}x on this device — no speed benefit; "
            "--precision int8 still pays its quantization error "
            "(cosine > 0.995 but not exact).  Prefer --precision fast "
            "unless memory-bound."
        )
    return ratio


def int8_kernel_rate_ratio(m: int = 16384, k: int = 768, n: int = 3072,
                           reps: int = 30, chain: int = 8) -> dict:
    """K8 against ``torch._int_mm`` (the library's s8 product) and the bf16
    ``torch.matmul`` at one backbone shape on the card: each timed call
    contracts the activation with ``chain`` weights, as JAX's
    ``int8_pallas_rate_ratio`` does. Returns TOP/s per path and the
    ratios. Needs a CUDA device."""
    dev = default_device()
    x8, w8 = _int8_operands(m, k, n, dev, chain)
    w8_kn = [w.t().contiguous() for w in w8]
    xb = x8.to(torch.bfloat16)
    wb = [w.to(torch.bfloat16) for w in w8_kn]
    paths = {
        "k8": lambda: [int8_matmul_nk(x8, w) for w in w8],
        "int_mm": lambda: [torch._int_mm(x8, w) for w in w8_kn],
        "bf16": lambda: [torch.matmul(xb, w) for w in wb],
    }
    ops = 2.0 * m * k * n * chain
    tops = {name: ops / _seconds(fn, reps, dev) / 1e12
            for name, fn in paths.items()}
    return {"shape": [m, k, n], "chain": chain, "tops": tops,
            "k8_vs_bf16": tops["k8"] / tops["bf16"],
            "k8_vs_int_mm": tops["k8"] / tops["int_mm"],
            "int_mm_vs_bf16": tops["int_mm"] / tops["bf16"]}
