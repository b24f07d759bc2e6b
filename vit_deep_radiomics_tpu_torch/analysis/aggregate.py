"""Cross-fold aggregation: per-epoch report JSONs → best epochs → summary
CSV.

Counterpart of ``vit_deep_radiomics_tpu/analysis/aggregate.py`` (the
reference's ``avg_kfold_metrics.py``): walks
``models/<folder>/<experiment>/<modality>/kfold_k/*.json``, picks each
fold's best epoch by the composite target metric, averages the folds
(mean ± std) and writes ``metrics/<folder>_metrics_sumary.csv`` with the
reference's column schema, its 'Sensivity' spelling included.

JAX's two fixes of the reference are kept:

* ``geometric_mean`` is cbrt(a·b·c) (the reference passes its third
  factor as ``np.cbrt``'s ``out`` argument, computing cbrt(a·b) and
  overwriting a column),
* Sensitivity is the recall of class 1 and Specificity that of class 0
  (the reference swaps them), under the reference's column names.

Host code (pandas); it reads the trainer's JSONs and no tensor.
"""

from __future__ import annotations

import html
import json
import os
import re
from pathlib import Path

import numpy as np
import pandas as pd

__all__ = [
    "harmonic_mean",
    "geometric_mean",
    "collect_fold_metrics",
    "best_epochs_per_fold",
    "write_training_curves",
    "aggregate_experiments",
]

_JSON_RE = re.compile(r"(train|test)_metrics_(\d+)\.json$")


def harmonic_mean(a, b):
    """2ab / (a + b)."""
    return (2 * a * b) / (a + b)


def geometric_mean(a, b, c):
    """cbrt(a·b·c), the reference's intended formula."""
    return np.cbrt(a * b * c)


def collect_fold_metrics(experiment_dir: str | os.PathLike) -> pd.DataFrame:
    """One row per ``kfold_k/{split}_metrics_{epoch}.json``: kfold, epoch,
    split and the auc / accuracy / loss / f1 / recall / precision
    columns."""
    rows = []
    experiment_dir = Path(experiment_dir)
    for fold_dir in sorted(experiment_dir.glob("kfold_*")):
        for fn in sorted(os.listdir(fold_dir)):
            m = _JSON_RE.search(fn)
            if not m:
                continue
            with open(fold_dir / fn) as fh:
                rep = json.load(fh)
            rows.append({
                "kfold": rep.get("kfold"),
                "epoch": int(m.group(2)),
                "split": m.group(1),
                "auc": rep.get("ROC AUC", np.nan),
                "accuracy": rep.get("accuracy", np.nan),
                "loss": rep.get("loss", np.nan),
                "f1_0": rep.get("0", {}).get("f1-score", np.nan),
                "f1_1": rep.get("1", {}).get("f1-score", np.nan),
                "recall_0": rep.get("0", {}).get("recall", np.nan),
                "recall_1": rep.get("1", {}).get("recall", np.nan),
                "precision_1": rep.get("1", {}).get("precision", np.nan),
            })
    if not rows:
        raise FileNotFoundError(f"no metric JSONs under {experiment_dir}")
    return pd.DataFrame(rows)


def best_epochs_per_fold(df: pd.DataFrame) -> pd.DataFrame:
    """Each fold's best epoch by the composite target: the geometric mean
    over AUC, f1₁ and f1₀ of test · harmonic(test, train)."""
    test = df[df["split"] == "test"].set_index(["kfold", "epoch"])
    train = df[df["split"] == "train"].set_index(["kfold", "epoch"])
    test, train = test.align(train, join="inner", axis=0)
    target = geometric_mean(
        test["auc"] * harmonic_mean(test["auc"], train["auc"]),
        test["f1_1"] * harmonic_mean(test["f1_1"], train["f1_1"]),
        test["f1_0"] * harmonic_mean(test["f1_0"], train["f1_0"]),
    )
    test = test.assign(target_metric=target).reset_index()
    test = test.sort_values("target_metric", ascending=False)
    return test.groupby("kfold", as_index=False).first()


def write_training_curves(df: pd.DataFrame, plots_dir, experiment: str,
                          modality: str) -> list[str]:
    """``{experiment}-{modality}-training_{loss,accuracy}.html`` under
    ``plots_dir``: one inline-SVG panel per fold (the reference animates
    the folds with plotly)."""
    from .reports import _svg_panel

    plots_dir = Path(plots_dir)
    plots_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for metric in ("loss", "accuracy"):
        panels = []
        for kfold, sub in df.groupby("kfold"):
            series = {}
            for split in ("train", "test"):
                rows = sub[sub["split"] == split].sort_values("epoch")
                if len(rows):
                    series[split] = (rows["epoch"].tolist(),
                                     rows[metric].tolist())
            if series:
                panels.append(_svg_panel(f"kfold {kfold} — {metric}",
                                         series))
        title = f"{experiment} {modality} training {metric}"
        doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
               f"<title>{html.escape(title)}</title></head><body>"
               f"<h2 style='font-family:sans-serif'>{html.escape(title)}"
               f"</h2>{''.join(panels)}</body></html>")
        path = plots_dir / f"{experiment}-{modality}-training_{metric}.html"
        with open(path, "w") as fh:
            fh.write(doc)
        written.append(str(path))
    return written


def aggregate_experiments(models_folder: str | os.PathLike,
                          metrics_dir: str | os.PathLike,
                          folder: str = "petct",
                          plots_dir: str | os.PathLike | None = None
                          ) -> pd.DataFrame:
    """Every experiment/modality under ``models_folder/folder`` → the
    summary frame, indexed (Dataset, Model, Modality, Split), mean ± std
    cells, written to ``metrics_dir/<folder>_metrics_sumary.csv``."""
    base = Path(models_folder) / folder
    summary_rows = []
    for experiment in sorted(p.name for p in base.iterdir() if p.is_dir()):
        exp_dir = base / experiment
        for modality in sorted(p.name for p in exp_dir.iterdir()
                               if p.is_dir()):
            df = collect_fold_metrics(exp_dir / modality)
            if plots_dir is not None:
                write_training_curves(df, Path(plots_dir) / "training",
                                      experiment, modality)
            best = best_epochs_per_fold(df)
            # the best (fold, epoch) overall, for later checkpoint picks
            top = best.sort_values("target_metric", ascending=False).iloc[0]
            # '<backbone>_<arch>_<dataset...>'
            parts = experiment.split("_")
            model_name = " ".join(parts[0:2])
            dataset = " ".join(parts[2:])

            best_rows = df.merge(best[["kfold", "epoch"]],
                                 on=["kfold", "epoch"])
            for split in ("train", "test"):
                rows = best_rows[best_rows["split"] == split]
                mean = rows.mean(numeric_only=True)
                std = rows.std(numeric_only=True)

                def cell(col):
                    return f"{mean[col]:,.3f} ± {std[col]:,.3f}"

                summary_rows.append({
                    "Dataset": dataset,
                    "Split": split,
                    "Model": model_name,
                    "Modality": modality,
                    "Accuracy": cell("accuracy"),
                    "AUC": cell("auc"),
                    "Precision": cell("precision_1"),
                    "Recall": cell("recall_1"),
                    "Specificity": cell("recall_0"),
                    "Sensivity": cell("recall_1"),
                    "Best Kfold": top["kfold"],
                    "Best Epoch": int(top["epoch"]),
                })

    out = pd.DataFrame(summary_rows)
    out = out.set_index(["Dataset", "Model", "Modality", "Split"]).sort_index(
        level=[0, 1, 2, 3], ascending=[True, True, True, False])
    metrics_dir = Path(metrics_dir)
    metrics_dir.mkdir(parents=True, exist_ok=True)
    out.round(3).to_csv(metrics_dir / f"{folder}_metrics_sumary.csv",
                        encoding="utf-8-sig")
    return out
