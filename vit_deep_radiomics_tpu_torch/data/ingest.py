"""Volume ingestion from tfds patient datasets, with PET liver normalisation.

Counterpart of ``vit_deep_radiomics_tpu/data/ingest.py`` (host code, numpy
only):

* :func:`samples_to_voxels` stacks per-slice samples into (H, W, S)
  volumes, divides PET by the mean nonzero liver uptake (+1e-10), reads the
  EGFR labels and the absolute spatial resolution with the null-resolution
  guard;
* :func:`load_tfds_pair` loads the PET and CT (``torax3d`` for Santa
  Maria) tfds datasets of a cohort and intersects their patient ids. It
  needs ``tensorflow_datasets`` (``HAS_TFDS``) and raises without it; the
  isotropic HDF5 (``data/synthetic.py::read_isotropic_hdf5``) is the
  source that needs nothing more.

``samples_to_voxels`` takes any iterable of mappings whose values are
arrays or expose ``.numpy()``, so tf tensors and plain dicts both work.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

__all__ = ["samples_to_voxels", "load_tfds_pair", "HAS_TFDS"]

try:
    import tensorflow_datasets as tfds

    HAS_TFDS = True
except ImportError:
    tfds = None
    HAS_TFDS = False


def _as_numpy(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def samples_to_voxels(samples: Iterable[Mapping], pet: bool = False):
    """Stack per-slice samples → (img, mask, labels, spatial_res).

    PET slices divide by the mean nonzero ``pet_liver`` value (+1e-10);
    ``spatial_res`` is |space_directions| of the last slice, with every
    entry replaced by the largest when one is not positive (a warning is
    printed)."""
    imgs, masks, labels = [], [], []
    sample = None
    for sample in samples:
        liver_mean = 1.0
        if pet:
            liver = _as_numpy(sample["pet_liver"])
            nz = liver[liver != 0]
            liver_mean = (nz.mean() if nz.size else 0.0) + 1e-10
        imgs.append(_as_numpy(sample["img_exam"]) / liver_mean)
        masks.append(_as_numpy(sample["mask_exam"]))
        labels.append(int(_as_numpy(sample["egfr_label"])))
    if sample is None:
        raise ValueError("no slices in sample stream")
    img = np.dstack(imgs)
    mask = np.dstack(masks)
    spatial_res = np.abs(
        _as_numpy(sample["exam_metadata"]["space_directions"])
    ).astype(np.float64)
    if spatial_res.min() <= 0:
        spatial_res = np.repeat(spatial_res.max(), spatial_res.shape)
        print("Warning: null voxel resolution; using max spacing")
    return img, mask, np.asarray(labels), spatial_res


def load_tfds_pair(dataset_name: str, data_dir):
    """(ds_pet, ds_ct, patient_ids) of one cohort: its PET and CT datasets
    and the sorted ids present in both. Raises ImportError without
    ``tensorflow_datasets``."""
    if not HAS_TFDS:
        raise ImportError(
            "the tfds source needs tensorflow_datasets, which is not "
            "installed; extract from the isotropic HDF5 instead "
            "(cli/extract.py --source isotropic)")
    ct_name = "ct" if dataset_name == "stanford_dataset" else "torax3d"
    ds_pet, _ = tfds.load(f"{dataset_name}/pet", data_dir=data_dir,
                          with_info=True)
    ds_ct, _ = tfds.load(f"{dataset_name}/{ct_name}", data_dir=data_dir,
                         with_info=True)
    patient_ids = sorted(set(ds_ct.keys()) & set(ds_pet.keys()))
    return ds_pet, ds_ct, patient_ids
