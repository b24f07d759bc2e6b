"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` inside the
package (listed in ``.gitignore``), then loaded with ``ctypes``. The hash
covers the source and every header in ``csrc/``, so an edited kernel is
rebuilt and a built one is reused. Nothing is compiled at import time:
:func:`load` builds on first use, and :func:`build_all` starts one
``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "KERNEL_SOURCES", "BUILDS", "build_all",
           "load", "spill_bytes", "ptxas_functions"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("fused_window_attention", "fused_global_attention",
                  "window_attention_bwd", "global_attention_fwd_lse",
                  "global_attention_bwd_dq", "global_attention_bwd_dkv",
                  "flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "flash_attention",
                  "fused_ln_mlp_residual", "int8_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: (source, seconds of its nvcc) of every build this process ran, in order
BUILDS: list[tuple[str, float]] = []


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, time.perf_counter())


def _finish(name: str, target: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp, t0 = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    tmp.replace(target)
    BUILDS.append((name, time.perf_counter() - t0))
    return log


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every kernel library, one ``nvcc`` per source in parallel.
    Returns each source's compiler log (empty when it was already built)."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def spill_bytes(log: str) -> int:
    """Bytes of spill stores and loads that ptxas reports in a
    ``-Xptxas -v`` log, summed over its kernels."""
    return sum(f["spill"] for f in ptxas_functions(log).values())


def ptxas_functions(log: str) -> dict[str, dict]:
    """Per kernel of a ``-Xptxas -v`` log: {mangled name: {"registers": n,
    "spill": bytes of spill stores and loads}}."""
    funcs: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            funcs.setdefault(name, {"registers": 0, "spill": 0})
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            funcs.setdefault(name, {"registers": 0, "spill": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            funcs[name]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            funcs[name]["registers"] = int(m.group(1))
    return funcs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                lib.vdr_error_string.restype = ctypes.c_char_p
                lib.vdr_error_string.argtypes = [ctypes.c_int]
                _libs[name] = lib
    return lib
