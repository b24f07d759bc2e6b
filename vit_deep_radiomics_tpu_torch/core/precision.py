"""Dtype policies: fp32 ``parity``, bf16 ``fast``, and the frozen-backbone
``inference`` and ``int8`` policies.

Counterpart of ``vit_deep_radiomics_tpu/core/precision.py``:

* ``parity``    — float32 compute and params. TF32 is switched off for both
  matmuls and cuDNN convolutions inside :meth:`Policy.backends` (the SAM
  neck's 3x3 conv would otherwise run in TF32 by default on the card).
* ``fast``      — bfloat16 compute, float32 params; every matmul
  accumulates in float32 (the tensor cores' bf16 path).
* ``inference`` — bfloat16 compute and params: the modules hold bf16
  parameters after init or load, so no matmul casts its weight.
* ``int8``      — ``inference`` with ``quantized``: the frozen backbone's
  five per-block matmuls run s8×s8→s32 (``ops/quant.py``, kernel K8).
  Trainable layers ignore it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["Policy", "PARITY", "FAST", "INFERENCE", "INT8", "cast_params",
           "get_policy"]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Precision policy threaded through models and engines."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    # dynamic int8 projections/MLP in the frozen backbone (ops/quant.py);
    # the trainable paths ignore it (round() has no useful gradient)
    quantized: bool = False

    def cast_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)

    @contextlib.contextmanager
    def backends(self):
        """Scope the float32 matmul/conv precision this policy needs.
        ``parity`` turns TF32 off inside the block and restores the flags
        after it; ``fast`` computes in bf16 and leaves them as they are."""
        if self.compute_dtype != torch.float32:
            yield
            return
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


PARITY = Policy(
    name="parity",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    output_dtype=torch.float32,
)

FAST = Policy(
    name="fast",
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
    output_dtype=torch.float32,
)

# Frozen-backbone inference: bf16 parameters, so every matmul reads half
# the weight bytes and skips the fp32→bf16 cast
INFERENCE = Policy(
    name="inference",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    output_dtype=torch.float32,
)

# INFERENCE with the per-block projection/MLP matmuls in s8×s8→s32 and
# dynamic per-token activation scales (ops/quant.py)
INT8 = Policy(
    name="int8",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    output_dtype=torch.float32,
    quantized=True,
)

_POLICIES = {"parity": PARITY, "fast": FAST, "inference": INFERENCE,
             "fp32": PARITY, "bf16": FAST, "int8": INT8}


def cast_params(params, dtype: torch.dtype):
    """Cast every floating tensor of a state dict (or a module, in place)
    to ``dtype``: fp32 → bf16 for the ``inference``/``int8`` policies
    after conversion or init."""
    if isinstance(params, torch.nn.Module):
        return params.to(dtype)
    return {k: v.to(dtype) if torch.is_floating_point(v) else v
            for k, v in params.items()}


def get_policy(name: str | Policy) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; choose from "
            f"{sorted(_POLICIES)}") from None
