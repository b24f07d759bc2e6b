"""What every kernel wrapper of ``ops/`` shares: the ctypes entry point of a
built ``csrc/<name>.cu`` and the launch counters.

Each ops module registers the counters of its own kernels with
:func:`register_launches` at import; a wrapper adds one to its counter
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches per wrapper since the last reset
LAUNCHES: dict[str, int] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def register_launches(*names: str) -> None:
    for name in names:
        LAUNCHES.setdefault(name, 0)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _load(name: str, argtypes, entry: str | None = None):
    """(library, entry point) of ``csrc/<name>.cu``, built on first use; the
    entry point is ``vdr_<name>`` unless another is named."""
    from ..utils import cuda_build

    lib = cuda_build.load(name)
    fn = getattr(lib, entry or f"vdr_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn
