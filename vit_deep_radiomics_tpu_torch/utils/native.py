"""ctypes bindings of the native token packer (``native/token_pack.cpp``).

Counterpart of the token half of ``vit_deep_radiomics_tpu/utils/
native.py``: the trainer's per-item host work (mask resize, 3D positional
encoding, masked token gather) as an OpenMP C++ library with a plain C
ABI, built with ``make -C native`` (g++) at first use. The dataset takes
the library when it loads and its numpy path otherwise; both compute the
same items (the library's encoding is in float64, the numpy path's in
float32).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "pack_tokens", "mask_features"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libtoken_pack.so"
_lib = None
_load_failed = False


def build(quiet: bool = True) -> bool:
    """Compile the shared library (idempotent). Returns success."""
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR),
                        "build/libtoken_pack.so"],
                       check=True, capture_output=quiet)
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists() and not build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _load_failed = True
        return None
    c_long = ctypes.c_long
    fptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.count_tokens.restype = c_long
    lib.count_tokens.argtypes = [fptr] + [c_long] * 5
    lib.pack_tokens.restype = c_long
    lib.pack_tokens.argtypes = (
        [fptr, fptr] + [c_long] * 6
        + [dptr, dptr, ctypes.c_double, ctypes.c_double, fptr, c_long])
    lib.mask_features.restype = None
    lib.mask_features.argtypes = [fptr, fptr] + [c_long] * 6 + [fptr]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def pack_tokens(features: np.ndarray, masks: np.ndarray,
                spatial_res: np.ndarray, noise: np.ndarray,
                pe_scale: float = 10000.0,
                pe_div: float = 4.0) -> np.ndarray | None:
    """Features (S, H, W, D) and image-res masks (S, Hm, Wm) → (n_tokens,
    D) packed tokens, or None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    features = np.ascontiguousarray(features, np.float32)
    masks = np.ascontiguousarray(masks, np.float32)
    s, h, w, d = features.shape
    hm, wm = masks.shape[1:3]
    n = lib.count_tokens(masks, s, hm, wm, h, w)
    out = np.empty((max(1, n), d), np.float32)
    wrote = lib.pack_tokens(
        features, masks, s, h, w, d, hm, wm,
        np.ascontiguousarray(spatial_res, np.float64),
        np.ascontiguousarray(noise, np.float64),
        float(pe_scale), float(pe_div), out, n)
    if wrote < 0:
        raise RuntimeError("token buffer undersized (count/pack mismatch)")
    return out[:wrote]


def mask_features(features: np.ndarray,
                  masks: np.ndarray) -> np.ndarray | None:
    """(S, H, W, D) features ⊙ the nearest-resized masks, or None."""
    lib = _load()
    if lib is None:
        return None
    features = np.ascontiguousarray(features, np.float32)
    masks = np.ascontiguousarray(masks, np.float32)
    s, h, w, d = features.shape
    hm, wm = masks.shape[1:3]
    out = np.empty_like(features)
    lib.mask_features(features, masks, s, h, w, d, hm, wm, out)
    return out
