"""Patient-stratified k-fold splits → the generated k-fold YAML.

Counterpart of ``vit_deep_radiomics_tpu/data/splits.py``: per (modality ×
dataset), ``StratifiedKFold(n_splits, shuffle=True, random_state=seed)``
over each patient's first label, written to ``conf/parameters_kfold.yaml``
under ``kfold_patients`` so ``utils/config.py`` picks it up. ``sklearn``
is imported inside :func:`build_kfold_patients`.
"""

from __future__ import annotations

import os
from typing import Mapping

from ..utils.config import save_yaml

__all__ = ["build_kfold_patients", "write_kfold_yaml"]


def build_kfold_patients(df, n_splits: int = 5, seed: int = 42) -> dict:
    """``{modality: {dataset: {fold: {'train': [...], 'test': [...]}}}}``
    (the same metadata gives the same folds as the reference)."""
    from sklearn.model_selection import StratifiedKFold

    kfold_patients: dict = {}
    for modality in df["modality"].unique():
        skf = StratifiedKFold(n_splits=n_splits, shuffle=True,
                              random_state=seed)
        dfm = df[df["modality"] == modality].reset_index(drop=True)
        kfold_patients[modality] = {}
        for dataset in dfm["dataset"].unique():
            patients_labels = (dfm[dfm["dataset"] == dataset]
                               .groupby("patient_id")["label"].first())
            patients = patients_labels.index.to_list()
            labels = patients_labels.to_list()
            kfold_patients[modality][dataset] = {
                k: {"train": [patients[i] for i in train_idx],
                    "test": [patients[i] for i in test_idx]}
                for k, (train_idx, test_idx) in enumerate(
                    skf.split(patients, labels))}
    return kfold_patients


def write_kfold_yaml(kfold_patients: Mapping,
                     conf_dir: str | os.PathLike) -> str:
    path = os.path.join(conf_dir, "parameters_kfold.yaml")
    save_yaml({"kfold_patients": dict(kfold_patients)}, path)
    return path
