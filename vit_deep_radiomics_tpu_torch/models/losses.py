"""Focal loss (the fine-tuning objective).

Counterpart of ``focal_loss`` in ``vit_deep_radiomics_tpu/models/
losses.py``: one-hot targets, PyTorch ``nll_loss`` weighting with sum
reduction, loss = Σᵢ αᵧᵢ · (1 − pᵧᵢ)^γ · (−log pᵧᵢ). The cross-modal loss
comes with the classifier slice.
"""

from __future__ import annotations

import torch

__all__ = ["focal_loss"]


def focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
               gamma: float = 2.0, alpha=None,
               example_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-class focal loss, sum reduction, α-weighted by target class."""
    logits = torch.atleast_2d(logits).float()
    targets_onehot = torch.atleast_2d(targets_onehot)
    class_idx = targets_onehot.argmax(dim=-1)
    if alpha is None:
        alpha = torch.ones(logits.shape[-1], dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
    logpt = torch.log_softmax(logits, dim=-1)
    focal = (1.0 - logpt.exp()) ** gamma * logpt
    picked = focal.gather(-1, class_idx[:, None])[:, 0]
    w = alpha[class_idx]
    if example_weight is not None:
        w = w * torch.as_tensor(example_weight, dtype=torch.float32,
                                device=logits.device)
    return -(w * picked).sum()
