"""A tiny synthetic feature store for the training tests of the port:
per-slice descriptor maps and image-res masks in the HDF5 layout, the
per-patient parquets and their merge, written with the port's own
``data/feature_store.py`` (JAX reads the same files)."""

from pathlib import Path

import numpy as np

AUGS = (("None", 0), ("horizontal", 90))
SPACING = {"ct": (0.8, 0.8, 1.5), "pet": (4.0, 4.0, 4.0)}


def write_store(root, n_patients=6, dim=16, slices=None, grid=4,
                mask_px=8, seed=0, full_masks=False, features=True):
    """``root/features/{features_masks_<mod>.hdf5, stanford_dataset/*.
    parquet, petct.parquet}``; returns (merged frame, CT store, PET
    store). Labels alternate; CT volumes are 16 slices (windows of 13),
    PET 4. Masks are small boxes, or cover every pixel with
    ``full_masks`` (``grid``² tokens a slice). Without ``features`` the
    HDF5 stores are not written (h5py is not touched): the parquets and
    the merged frame alone, the same frame."""
    from vit_deep_radiomics_tpu_torch.data import feature_store

    slices = slices or {"ct": 16, "pet": 4}
    rng = np.random.default_rng(seed)
    feat_dir = Path(root) / "features"
    ds_dir = feat_dir / "stanford_dataset"
    ds_dir.mkdir(parents=True, exist_ok=True)
    stores = {m: feat_dir / f"features_masks_{m}.hdf5" for m in slices}
    for p in range(n_patients):
        pid = f"P{p:03d}"
        for mod, n in slices.items():
            feats, masks, rows_s, rows_a, rows_f = [], [], [], [], []
            for s in range(n):
                for flip, angle in AUGS:
                    feats.append(rng.normal(size=(grid, grid, dim))
                                 .astype(np.float32))
                    m = np.full((mask_px, mask_px), float(full_masks),
                                np.float32)
                    r0, c0 = rng.integers(0, mask_px // 2, 2)
                    m[r0:r0 + 3 + p % 2, c0:c0 + 4] = 1.0
                    masks.append(m)
                    rows_s.append(s)
                    rows_a.append(angle)
                    rows_f.append(flip)
            if features:
                feature_store.save_features(stores[mod], feats, masks, pid)
            feature_store.slice_metadata_frame(
                rows_s, rows_a, rows_f, pid, p % 2, "stanford", mod,
                np.asarray(SPACING[mod])).to_parquet(
                    ds_dir / f"{pid}_{mod}.parquet")
    df = feature_store.merge_metadata(feat_dir, datasets=("stanford_dataset",))
    return df, stores["ct"], stores["pet"]


def tiny_cfg(folds=None, dim=16, epochs=2):
    """The models config at 2 layers, narrow widths."""
    layer = {"num_layers": 2, "num_heads": 2, "mlp_ratio": 2}
    cfg = {"models": {
        "transformer": {"learning_rate": 5e-4, "feature_dim": dim,
                        "batch_size": 2, "virtual_batch_size": 4,
                        "num_epochs": epochs, "patience": 15,
                        "ct": layer, "pet": layer, "chest": layer},
        "conv": {"learning_rate": 5e-4, "feature_dim": dim,
                 "batch_size": 2, "virtual_batch_size": 4,
                 "num_epochs": epochs, "patience": 15,
                 "ct": {"div": 2}, "pet": {"div": 2}}}}
    if folds is not None:
        cfg["kfold_patients"] = folds
    return cfg
