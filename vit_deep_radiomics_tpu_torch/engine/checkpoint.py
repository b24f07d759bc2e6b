"""Checkpointing: parameters + optimizer state + training progress.

Counterpart of ``vit_deep_radiomics_tpu/engine/checkpoint.py`` with its
contract: the file stem ``model_epoch_NNNN`` under a fold directory, the
metric history beside it as ``history_NNNN.json`` (JAX's bytes: ``json.
dump`` with default separators), writes to a ``.tmp`` file renamed into
place (a reader never sees a partial file), and one writer thread for the
asynchronous path. The payload is ``torch.save`` of ``{"params":
model.state_dict(), "opt_state": optimizer.state_dict(), "epoch": int}``
in a ``.pt`` file (JAX writes flax msgpack).

:func:`save_checkpoint_async` copies every tensor to the host before it
returns (the trainer updates the live tensors in place), then leaves the
serialisation and the file write to the writer thread; call
:func:`wait_pending` before reading the files or exiting.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import re
from pathlib import Path

import torch

__all__ = [
    "save_checkpoint",
    "save_checkpoint_async",
    "wait_pending",
    "load_checkpoint",
    "latest_epoch",
    "best_epochs",
]

SUFFIX = ".pt"
_FILE_RE = re.compile(r"model_epoch_(\d+)" + re.escape(SUFFIX) + "$")

# one writer thread: writes stay ordered, and host memory holds at most
# one snapshot in flight
_WRITER: concurrent.futures.ThreadPoolExecutor | None = None
_PENDING: list[concurrent.futures.Future] = []


def _path(save_dir, epoch: int) -> Path:
    return Path(save_dir) / f"model_epoch_{epoch:04d}{SUFFIX}"


def _to_host(obj):
    """A copy of ``obj`` with every tensor detached on the CPU (a copy even
    of CPU tensors, which the trainer keeps updating in place)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return copy.deepcopy(obj)


def _write(payload: dict, history, save_dir: Path, epoch: int) -> str:
    path = _path(save_dir, epoch)
    tmp = path.with_suffix(SUFFIX + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if history is not None:
        hist = save_dir / f"history_{epoch:04d}.json"
        hist_tmp = hist.with_suffix(".json.tmp")
        with open(hist_tmp, "w") as fh:
            json.dump(history, fh)
        os.replace(hist_tmp, hist)
    return str(path)


def _split(state: dict, save_dir):
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    payload = dict(state)
    history = payload.pop("history", None)
    return _to_host(payload), copy.deepcopy(history), save_dir


def save_checkpoint(state: dict, save_dir, epoch: int) -> str:
    """Write ``{'params', 'opt_state', 'epoch'}`` to
    ``model_epoch_NNNN.pt`` and ``state['history']`` (if any) to
    ``history_NNNN.json`` (blocking)."""
    payload, history, save_dir = _split(state, save_dir)
    return _write(payload, history, save_dir, epoch)


def save_checkpoint_async(state: dict, save_dir, epoch: int):
    """:func:`save_checkpoint` on the writer thread; returns Future[str].
    The host copy is taken before returning; a previous write still in
    flight is waited for first (one snapshot in host memory)."""
    global _WRITER
    payload, history, save_dir = _split(state, save_dir)
    if _PENDING:
        wait_pending()
    if _WRITER is None:
        _WRITER = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
    fut = _WRITER.submit(_write, payload, history, save_dir, epoch)
    _PENDING.append(fut)
    return fut


def wait_pending() -> list[str]:
    """Block until every asynchronous checkpoint is on disk; returns the
    paths. The pending list is cleared before a failed write re-raises, so
    the failure surfaces once."""
    pending, _PENDING[:] = list(_PENDING), []
    done, first_err = [], None
    for f in pending:
        try:
            done.append(f.result())
        except Exception as e:      # noqa: BLE001 — re-raised below
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    return done


def load_checkpoint(save_dir, epoch: int, map_location="cpu") -> dict:
    """``{'params', 'opt_state', 'epoch'}`` of one checkpoint, and
    ``'history'`` when its JSON is there."""
    state = torch.load(_path(save_dir, epoch),
                       map_location=map_location, weights_only=True)
    hist_path = Path(save_dir) / f"history_{epoch:04d}.json"
    if hist_path.exists():
        with open(hist_path) as fh:
            state["history"] = json.load(fh)
    return state


def _epochs(save_dir) -> list[int]:
    save_dir = Path(save_dir)
    if not save_dir.is_dir():
        return []
    return [int(m.group(1)) for fn in os.listdir(save_dir)
            if (m := _FILE_RE.search(fn))]


def latest_epoch(save_dir) -> int | None:
    """Highest checkpointed epoch of a fold directory (the resume point)."""
    epochs = _epochs(save_dir)
    return max(epochs) if epochs else None


def best_epochs(save_dir) -> list[int]:
    """Every checkpointed epoch, sorted (the gate saves only improvers)."""
    return sorted(_epochs(save_dir))
