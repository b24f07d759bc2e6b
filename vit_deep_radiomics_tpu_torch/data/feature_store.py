"""Feature store: HDF5 descriptor maps + parquet per-slice metadata.

The port's own copy of the contract of
``vit_deep_radiomics_tpu/data/feature_store.py``:

* HDF5 layout ``{patient_id}/features/{i}`` and ``{patient_id}/masks/{i}``,
  lzf-compressed through h5py's own filter (the parallel LZF writer over
  ``native/lzf_codec.cpp`` has no port), overwrite-if-exists,
* per-patient parquet with columns feature_id, slice, angle, flip,
  patient_id, label, dataset, modality, augmentation, spatial_res.

``h5py`` and ``pandas`` are imported inside the functions.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = [
    "save_features",
    "read_patient_features",
    "patient_ids_in_store",
    "slice_metadata_frame",
]


def save_features(filename: str | os.PathLike,
                  all_features: Sequence[np.ndarray],
                  all_masks: Sequence[np.ndarray], patient_id: str) -> None:
    """Write one patient's per-slice feature maps + masks (lzf chunks of
    one whole array each), replacing any earlier group of that patient."""
    import h5py

    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(filename, "a") as h5f:
        if patient_id in h5f:
            del h5f[patient_id]
        group = h5f.create_group(patient_id)
        for i, (feature, mask) in enumerate(zip(all_features, all_masks)):
            feature = np.ascontiguousarray(feature)
            mask = np.ascontiguousarray(mask)
            group.create_dataset(f"features/{i}", data=feature,
                                 compression="lzf", chunks=feature.shape)
            group.create_dataset(f"masks/{i}", data=mask,
                                 compression="lzf", chunks=mask.shape)


def read_patient_features(filename: str | os.PathLike, patient_id: str):
    """(features, masks) lists for a patient, in feature_id order."""
    import h5py

    features, masks = [], []
    with h5py.File(filename, "r") as h5f:
        group = h5f[patient_id]
        for fid in sorted(int(k) for k in group["features"].keys()):
            features.append(group[f"features/{fid}"][()])
            masks.append(group[f"masks/{fid}"][()])
    return features, masks


def patient_ids_in_store(filename: str | os.PathLike) -> list[str]:
    import h5py

    with h5py.File(filename, "r") as h5f:
        return list(h5f.keys())


def slice_metadata_frame(slices: Sequence[int], angles: Sequence[int],
                         flips: Sequence[str | None], patient_id: str,
                         label: int, dataset: str, modality: str,
                         spatial_res: np.ndarray):
    """Per-slice metadata rows; ``augmentation`` is False only for the
    identity flip + angle."""
    import pandas as pd

    df = pd.DataFrame({
        "slice": list(slices),
        "angle": list(angles),
        "flip": [str(f) for f in flips],
    })
    df = df.reset_index(drop=False).rename(columns={"index": "feature_id"})
    df["patient_id"] = patient_id
    df["label"] = label
    df["dataset"] = dataset
    df["modality"] = modality
    df["augmentation"] = ~((df["flip"] == "None") & (df["angle"] == 0))
    df["spatial_res"] = [np.asarray(spatial_res, np.float64)] * len(df)
    return df
