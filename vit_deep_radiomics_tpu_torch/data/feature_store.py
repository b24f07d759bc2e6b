"""Feature store: HDF5 descriptor maps + parquet per-slice metadata.

The port's own copy of the contract of
``vit_deep_radiomics_tpu/data/feature_store.py``:

* HDF5 layout ``{patient_id}/features/{i}`` and ``{patient_id}/masks/{i}``,
  lzf-compressed through h5py's own filter (the parallel LZF writer over
  ``native/lzf_codec.cpp`` has no port), overwrite-if-exists,
* per-patient parquet with columns feature_id, slice, angle, flip,
  patient_id, label, dataset, modality, augmentation, spatial_res,
  merged into ``petct.parquet`` by :func:`merge_metadata`;
* :func:`merge_part_stores` folds the per-process part stores of a
  multi-process sweep into the contract files.

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
    "merge_metadata",
    "merge_part_stores",
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


def merge_metadata(feature_dir: str | os.PathLike,
                   datasets: Sequence[str] = ("santa_maria_dataset",
                                              "stanford_dataset"),
                   output_path: str | os.PathLike | None = None):
    """Concatenate the per-patient parquets of each dataset folder into
    ``petct.parquet`` (``flip`` as text, ``augmentation`` recomputed)."""
    import pandas as pd

    feature_dir = Path(feature_dir)
    frames = []
    for dataset in datasets:
        ds_dir = feature_dir / dataset
        if ds_dir.is_dir():
            frames.extend(pd.read_parquet(fn)
                          for fn in sorted(ds_dir.iterdir())
                          if fn.suffix == ".parquet")
    if not frames:
        raise FileNotFoundError(
            f"no per-patient parquets under {feature_dir}")
    df = pd.concat(frames)
    df["flip"] = df["flip"].astype(str)
    df["augmentation"] = ~((df["flip"] == "None") & (df["angle"] == 0))
    df = df.reset_index(drop=True)
    out = Path(output_path) if output_path else feature_dir / "petct.parquet"
    df.to_parquet(out)
    return df


def merge_part_stores(feature_folder: str | os.PathLike,
                      modalities: Sequence[str] = ("pet", "ct"),
                      remove_parts: bool = True) -> list[str]:
    """Fold ``features_masks_<mod>.part<pid>.hdf5`` stores (one writer per
    process, disjoint patients) into ``features_masks_<mod>.hdf5`` by
    group copy; returns the merged stores."""
    import h5py

    feature_folder = Path(feature_folder)
    merged: list[str] = []
    for modality in modalities:
        parts = sorted(
            feature_folder.glob(f"features_masks_{modality}.part*.hdf5"))
        if not parts:
            continue
        out = feature_folder / f"features_masks_{modality}.hdf5"
        with h5py.File(out, "a") as dst:
            for part in parts:
                with h5py.File(part, "r") as src:
                    for pid in src:
                        if pid in dst:
                            del dst[pid]
                        src.copy(src[pid], dst, name=pid)
        if remove_parts:
            for part in parts:
                part.unlink()
        merged.append(str(out))
    return merged
