"""Metric reports: per-epoch JSON, console rendering and HTML curves.

Counterpart of ``vit_deep_radiomics_tpu/analysis/reports.py`` with the
reference's artifact contract:

* per-epoch classification-report dicts (sklearn's schema) with ``ROC
  AUC`` / ``kfold`` / ``loss`` / ``epoch`` / ``split`` added →
  ``{split}_metrics_{epoch}.json``; the trainer builds them with
  :func:`device_epoch_report` (``ops/metrics.py`` on the card, the host
  receiving the scalars), :func:`epoch_report` is the sklearn version,
* a console rendering,
* ``losses.html``: the loss/AUC/F1/target-metric 2×2 figure, an inline-SVG
  writer with no dependency, or plotly when it imports.

``sklearn`` and ``plotly`` are imported by the functions that use them.
"""

from __future__ import annotations

import html
import json
import os
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from .. import default_device

__all__ = [
    "epoch_report",
    "device_epoch_report",
    "save_report_json",
    "format_report",
    "write_metrics_html",
]


def epoch_report(y_true, y_score, sample_weight: Sequence[float] | None, *,
                 kfold, loss: float, epoch: int, split: str) -> dict:
    """Classification report dict by sklearn, the reference's schema."""
    from sklearn.metrics import classification_report, roc_auc_score

    y_pred = (np.asarray(y_score) >= 0.5).astype(int)
    report = classification_report(y_true, y_pred, output_dict=True,
                                   zero_division=0,
                                   sample_weight=sample_weight)
    try:
        report["ROC AUC"] = float(roc_auc_score(
            y_true, y_score, sample_weight=sample_weight))
    except ValueError:  # one class in the split: AUC undefined
        report["ROC AUC"] = float("nan")
    report["kfold"] = kfold
    report["loss"] = float(loss)
    report["epoch"] = int(epoch)
    report["split"] = split
    return report


def device_epoch_report(y_true, y_score,
                        sample_weight: Sequence[float] | None, *, kfold,
                        loss: float, epoch: int, split: str,
                        device: str | torch.device | None = None) -> dict:
    """:func:`epoch_report` computed by ``ops/metrics.py`` on ``device``
    (the card unless the caller names one): weighted tie-correct ROC-AUC
    and the confusion-count report in fp32, one host transfer for all the
    scalars. The schema is sklearn's: per-class precision/recall/f1-score/
    support for the classes present in y_true ∪ y_pred, accuracy, macro
    and weighted averages over those classes."""
    from ..ops.metrics import binary_counts, binary_report_metrics, roc_auc

    dev = default_device(device)
    yt = torch.as_tensor(np.asarray(y_true), dtype=torch.float32,
                         device=dev)
    ys = torch.as_tensor(np.asarray(y_score), dtype=torch.float32,
                         device=dev)
    w = None if sample_weight is None else torch.as_tensor(
        np.asarray(sample_weight), dtype=torch.float32, device=dev)
    yp = (ys >= 0.5).float()
    m = binary_report_metrics(yt, yp, w)
    counts = binary_counts(yt, yp, w)
    auc = roc_auc(yt, ys, w)
    keys = list(m)
    host = torch.stack([m[k] for k in keys] + list(counts) + [auc]).cpu()
    vals = dict(zip(keys, (float(v) for v in host[:len(keys)])))
    tp, fp, tn, fn, auc = (float(v) for v in host[len(keys):])

    support_0, support_1 = tn + fp, tp + fn
    total = support_0 + support_1
    if support_0 == 0 or support_1 == 0:
        auc = float("nan")   # sklearn raises on one class; epoch_report: nan

    def cls(prec, rec, f1, support):
        return {"precision": prec, "recall": rec, "f1-score": f1,
                "support": support}

    def avg(k0, k1):
        if total <= 0:
            return 0.0
        return (vals[k0] * support_0 + vals[k1] * support_1) / total

    present = [c for c, seen in (
        ("0", support_0 > 0 or (tn + fn) > 0),
        ("1", support_1 > 0 or (tp + fp) > 0)) if seen]
    report = {c: cls(vals[f"precision_{c}"], vals[f"recall_{c}"],
                     vals[f"f1_{c}"], (support_0, support_1)[int(c)])
              for c in present}
    n_present = max(1, len(present))
    report.update({
        "accuracy": vals["accuracy"],
        "macro avg": cls(
            sum(vals[f"precision_{c}"] for c in present) / n_present,
            sum(vals[f"recall_{c}"] for c in present) / n_present,
            sum(vals[f"f1_{c}"] for c in present) / n_present, total),
        "weighted avg": cls(avg("precision_0", "precision_1"),
                            avg("recall_0", "recall_1"),
                            avg("f1_0", "f1_1"), total),
        "ROC AUC": auc,
        "kfold": kfold,
        "loss": float(loss),
        "epoch": int(epoch),
        "split": split,
    })
    return report


def save_report_json(report: Mapping, save_dir, split: str,
                     epoch: int) -> str:
    """``{split}_metrics_{epoch}.json``."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / f"{split}_metrics_{epoch}.json"
    with open(path, "w") as fh:
        json.dump(dict(report), fh)
    return str(path)


def format_report(report: Mapping) -> str:
    """Console rendering of a report."""
    lines = [
        f"split={report.get('split')} epoch={report.get('epoch')} "
        f"kfold={report.get('kfold')} loss={report.get('loss'):.4f} "
        f"AUC={report.get('ROC AUC'):.4f} "
        f"acc={report.get('accuracy', float('nan')):.4f}",
    ]
    for c in ("0", "1"):
        if c in report:
            r = report[c]
            lines.append(
                f"  class {c}: precision={r['precision']:.3f} "
                f"recall={r['recall']:.3f} f1={r['f1-score']:.3f} "
                f"support={r['support']:.1f}")
    if "macro avg" in report:
        lines.append(f"  macro: f1={report['macro avg']['f1-score']:.3f}")
    return "\n".join(lines)


# -- HTML curves --------------------------------------------------------------

_SVG_W, _SVG_H, _PAD = 460, 260, 40
_COLORS = {"train": "#d62728", "test": "#1f77b4", "single": "#2ca02c"}
_METRICS = ("loss", "auc", "f1", "target_metric")


def _svg_panel(title: str, series: dict[str, tuple[list, list]]) -> str:
    """One SVG line chart; series: name → (xs, ys)."""
    all_y = [y for _, ys in series.values() for y in ys if np.isfinite(y)]
    all_x = [x for xs, _ in series.values() for x in xs]
    if not all_y:
        return ""
    ymin, ymax = min(all_y), max(all_y)
    if ymax == ymin:
        ymax = ymin + 1e-9
    xmin, xmax = min(all_x), max(all_x)
    if xmax == xmin:
        xmax = xmin + 1

    def sx(x):
        return _PAD + (x - xmin) / (xmax - xmin) * (_SVG_W - 2 * _PAD)

    def sy(y):
        return _SVG_H - _PAD - (y - ymin) / (ymax - ymin) * (_SVG_H - 2 * _PAD)

    parts = [
        f'<svg width="{_SVG_W}" height="{_SVG_H}" '
        f'style="background:#fff;border:1px solid #ddd">',
        f'<text x="{_SVG_W/2}" y="16" text-anchor="middle" '
        f'font-size="13" font-family="sans-serif">{html.escape(title)}</text>',
        f'<text x="6" y="{_PAD}" font-size="10" font-family="monospace">'
        f"{ymax:.3g}</text>",
        f'<text x="6" y="{_SVG_H - _PAD}" font-size="10" '
        f'font-family="monospace">{ymin:.3g}</text>',
    ]
    for li, (name, (xs, ys)) in enumerate(series.items()):
        color = _COLORS.get(name.split("_")[0], "#555")
        pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}"
                       for x, y in zip(xs, ys) if np.isfinite(y))
        parts.append(f'<polyline fill="none" stroke="{color}" '
                     f'stroke-width="1.5" points="{pts}"/>')
        parts.append(
            f'<text x="{_PAD}" y="{28 + 12 * li}" font-size="10" '
            f'fill="{color}" font-family="sans-serif">{html.escape(name)}'
            f"</text>")
    parts.append("</svg>")
    return "".join(parts)


def write_metrics_html(history: Mapping[str, Sequence],
                       path: str | os.PathLike, title: str) -> str:
    """The loss/AUC/F1/target-metric 2×2 figure of a history dict
    (``{"epoch": [...], "train_loss": [...], ...}``) → standalone HTML,
    by plotly when it imports, else by the SVG writer."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    history = {k: list(v) for k, v in history.items()}
    try:
        import plotly  # noqa: F401
    except ImportError:
        pass
    else:
        return _write_plotly(history, path, title)

    xs = history["epoch"]
    panels = []
    for name in _METRICS:
        series = {}
        if f"train_{name}" in history:
            series[f"train_{name}"] = (xs, history[f"train_{name}"])
            series[f"test_{name}"] = (xs, history[f"test_{name}"])
        elif name in history:
            series["single"] = (xs, history[name])
        if series:
            panels.append(_svg_panel(name.upper(), series))
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{html.escape(title)}</title></head><body>"
           f"<h2 style='font-family:sans-serif'>{html.escape(title)}</h2>"
           f"{''.join(panels)}</body></html>")
    with open(path, "w") as fh:
        fh.write(doc)
    return str(path)


def _write_plotly(history: dict, path: Path, title: str) -> str:
    import plotly.graph_objs as go
    from plotly.subplots import make_subplots

    grid = [(1, 1), (1, 2), (2, 1), (2, 2)]
    fig = make_subplots(rows=2, cols=2, shared_xaxes=True,
                        subplot_titles=[n.upper() for n in _METRICS])
    for (r, c), name in zip(grid, _METRICS):
        if f"train_{name}" in history:
            for split, color in (("train", "red"), ("test", "blue")):
                fig.append_trace(go.Scatter(
                    x=history["epoch"], y=history[f"{split}_{name}"],
                    mode="lines+markers", marker_color=color,
                    name=f"{split}_{name}"), row=r, col=c)
        elif name in history:
            fig.append_trace(go.Scatter(
                x=history["epoch"], y=history[name], mode="lines+markers",
                marker_color="green", name=name), row=r, col=c)
    fig.update_layout(title_text=title, xaxis_title="Epochs")
    fig.write_html(str(path))
    return str(path)
