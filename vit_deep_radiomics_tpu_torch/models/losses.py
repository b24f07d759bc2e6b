"""Focal and cross-modal focal losses.

Counterpart of ``vit_deep_radiomics_tpu/models/losses.py``: one-hot
targets, PyTorch ``nll_loss`` weighting semantics, and an optional
per-example weight so padded batch entries drop out.

* :func:`focal_loss`, sum reduction: Σᵢ αᵧᵢ · ℓᵢ (the fine-tuning and
  unimodal classifier objective),
* :func:`cross_modal_focal_loss`, each term a weighted mean
  Σᵢ αᵧᵢ · ℓᵢ / Σᵢ αᵧᵢ (the bimodal classifier's objective).
"""

from __future__ import annotations

import torch

__all__ = ["focal_loss", "cross_modal_focal_loss"]


def _prep(targets_onehot, alpha, num_classes, device):
    class_idx = targets_onehot.argmax(dim=-1)
    if alpha is None:
        alpha = torch.ones(num_classes, dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return class_idx, alpha


def _class_weights(class_idx, alpha, example_weight, device):
    w = alpha[class_idx]
    if example_weight is not None:
        w = w * torch.as_tensor(example_weight, dtype=torch.float32,
                                device=device)
    return w


def focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
               gamma: float = 2.0, alpha=None,
               example_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-class focal loss, sum reduction, α-weighted by target class:
    loss = Σᵢ αᵧᵢ · (1 − pᵧᵢ)^γ · (−log pᵧᵢ)."""
    logits = torch.atleast_2d(logits).float()
    targets_onehot = torch.atleast_2d(targets_onehot)
    class_idx, alpha = _prep(targets_onehot, alpha, logits.shape[-1],
                             logits.device)
    logpt = torch.log_softmax(logits, dim=-1)
    focal = (1.0 - logpt.exp()) ** gamma * logpt
    picked = focal.gather(-1, class_idx[:, None])[:, 0]
    w = _class_weights(class_idx, alpha, example_weight, logits.device)
    return -(w * picked).sum()


def cross_modal_focal_loss(
    logits_petct: torch.Tensor, logits_ct: torch.Tensor,
    logits_pet: torch.Tensor, targets_onehot: torch.Tensor,
    gamma_bimodal: float = 1.0, gamma_unimodal: float = 2.0, alpha=None,
    beta: float = 0.6, eps: float = 1e-8,
    example_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cross-modal focal loss: a focal joint term (γ_bimodal) and the two
    per-modality terms gated by the harmonic-mean agreement
    ``pt_mean = 2·pt_ct·pt_pet / (pt_ct + pt_pet + ε)``;
    total = β·L_petct + (1 − β)·(L_ct + L_pet), each L a weighted mean."""
    logits_petct, logits_ct, logits_pet = (
        torch.atleast_2d(x).float()
        for x in (logits_petct, logits_ct, logits_pet))
    targets_onehot = torch.atleast_2d(targets_onehot)
    device = logits_petct.device
    class_idx, alpha = _prep(targets_onehot, alpha, logits_petct.shape[-1],
                             device)
    logpt_joint = torch.log_softmax(logits_petct, dim=-1)
    logpt_ct = torch.log_softmax(logits_ct, dim=-1)
    logpt_pet = torch.log_softmax(logits_pet, dim=-1)
    pt_joint, pt_ct, pt_pet = logpt_joint.exp(), logpt_ct.exp(), \
        logpt_pet.exp()
    pt_mean = (2.0 * pt_ct * pt_pet) / (pt_ct + pt_pet + eps)
    w = _class_weights(class_idx, alpha, example_weight, device)
    denom = torch.clamp(w.sum(), min=eps)

    def weighted_mean_nll(modulated_logpt):
        picked = modulated_logpt.gather(-1, class_idx[:, None])[:, 0]
        return -(w * picked).sum() / denom

    loss_joint = weighted_mean_nll((1.0 - pt_joint) ** gamma_bimodal
                                   * logpt_joint)
    loss_ct = weighted_mean_nll((1.0 - pt_mean * pt_ct) ** gamma_unimodal
                                * logpt_ct)
    loss_pet = weighted_mean_nll((1.0 - pt_mean * pt_pet) ** gamma_unimodal
                                 * logpt_pet)
    return beta * loss_joint + (1.0 - beta) * (loss_ct + loss_pet)
