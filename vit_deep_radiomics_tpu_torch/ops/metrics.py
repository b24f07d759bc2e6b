"""Classification metrics on the tensors' device: weighted ROC-AUC and the
confusion-count report.

Counterpart of ``vit_deep_radiomics_tpu/ops/metrics.py``: the trainer's
per-epoch AUC and F1 are sort-based reductions on the card, and the host
receives only the final scalars (no sklearn in the live loop). Every
function takes an optional weight vector; zero-weight entries drop out.
"""

from __future__ import annotations

import torch

__all__ = ["roc_auc", "binary_counts", "binary_report_metrics"]


def _weights(y_true: torch.Tensor, weight) -> torch.Tensor:
    if weight is None:
        return torch.ones_like(y_true)
    return torch.as_tensor(weight, dtype=torch.float32, device=y_true.device)


def roc_auc(y_true, y_score, weight=None) -> torch.Tensor:
    """Weighted binary ROC-AUC by trapezoids, tie-correct (sklearn's
    ``roc_auc_score`` with ``sample_weight``): scores sorted descending,
    weighted TP/FP counts accumulated, each tie group read at its last
    point. NaN when a class is absent."""
    y_true = torch.as_tensor(y_true, dtype=torch.float32)
    y_score = torch.as_tensor(y_score, dtype=torch.float32,
                              device=y_true.device)
    w = _weights(y_true, weight)
    y_score = torch.where(w > 0, y_score,
                          torch.full_like(y_score, float("-inf")))
    order = torch.argsort(-y_score, stable=True)
    s, t, ww = y_score[order], y_true[order], w[order]
    tps = torch.cumsum(ww * t, 0)
    fps = torch.cumsum(ww * (1.0 - t), 0)
    n = s.shape[0]
    boundary = torch.cat([s[:-1] != s[1:],
                          torch.ones(1, dtype=torch.bool, device=s.device)])
    idx = torch.arange(n, device=s.device)
    # the last index of each tie group: a reverse running minimum over the
    # group boundaries
    marks = torch.where(boundary, idx, torch.full_like(idx, n))
    group_last = torch.flip(torch.cummin(torch.flip(marks, (0,)), 0).values,
                            (0,))
    tps, fps = tps[group_last], fps[group_last]
    tp_total, fp_total = tps[-1], fps[-1]
    zero = torch.zeros(1, device=s.device)
    tps = torch.cat([zero, tps])
    fps = torch.cat([zero, fps])
    area = torch.sum((fps[1:] - fps[:-1]) * (tps[1:] + tps[:-1]) / 2.0)
    denom = tp_total * fp_total
    return torch.where(denom > 0, area / denom,
                       torch.full_like(area, float("nan")))


def binary_counts(y_true, y_pred, weight=None):
    """Weighted (tp, fp, tn, fn) of binary labels and predictions."""
    y_true = torch.as_tensor(y_true, dtype=torch.float32)
    y_pred = torch.as_tensor(y_pred, dtype=torch.float32,
                             device=y_true.device)
    w = _weights(y_true, weight)
    tp = torch.sum(w * y_true * y_pred)
    fp = torch.sum(w * (1 - y_true) * y_pred)
    tn = torch.sum(w * (1 - y_true) * (1 - y_pred))
    fn = torch.sum(w * y_true * (1 - y_pred))
    return tp, fp, tn, fn


def _safe_div(a, b):
    return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def binary_report_metrics(y_true, y_pred, weight=None) -> dict:
    """Per-class precision/recall/F1, accuracy and macro F1, a zero
    denominator giving 0 (sklearn's ``zero_division=0``)."""
    tp, fp, tn, fn = binary_counts(y_true, y_pred, weight)
    prec1, rec1 = _safe_div(tp, tp + fp), _safe_div(tp, tp + fn)
    f1_1 = _safe_div(2 * prec1 * rec1, prec1 + rec1)
    prec0, rec0 = _safe_div(tn, tn + fn), _safe_div(tn, tn + fp)
    f1_0 = _safe_div(2 * prec0 * rec0, prec0 + rec0)
    return {
        "precision_0": prec0, "recall_0": rec0, "f1_0": f1_0,
        "precision_1": prec1, "recall_1": rec1, "f1_1": f1_1,
        "accuracy": _safe_div(tp + tn, tp + fp + tn + fn),
        "macro_f1": (f1_0 + f1_1) / 2.0,
    }
