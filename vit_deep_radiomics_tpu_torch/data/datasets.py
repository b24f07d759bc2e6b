"""Training dataset: sub-volume windows → padded token batches.

Counterpart of ``vit_deep_radiomics_tpu/data/datasets.py``, item for item:
one seed gives the same items in both packages (the same numpy-Generator
draws in the same order).

* :func:`prepare_windows` assigns the reference's ``patient_id_new``
  sub-volume ids: CT/chest volumes in stride-1 windows of 13 slices (PET
  2), PET rows grouped by ``ceil(slice/divisor)``; a volume no longer
  than its window keeps one window.
* :class:`PETCTDataset` reads the HDF5 maps, masks them, gives each voxel
  physical (mm) coordinates and adds the 3D sin/cos encoding / 4
  (``utils/native.py`` when its library loads, else the numpy path with
  ``ops/posenc.py``); conv items are masked (S, h, w, D) volumes. With
  augmentation it draws a flip/angle, a sub-window, ±5 mm jitter, a
  0.85–1.15 resolution scale and a crop of at least 7 slices.
* :func:`batch_items` pads token sequences to buckets with boolean masks
  (conv volumes to shape buckets with voxel masks).

``pandas`` and ``h5py`` are imported by the functions that need them:
``batch_items`` and :class:`TokenItem` run without either.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator, Sequence

import numpy as np

from ..data import feature_store
from ..ops.posenc import positional_encoding_3d
from ..utils import native

__all__ = [
    "find_divisor",
    "voxel_tokens",
    "prepare_windows",
    "nearest_resize",
    "TokenItem",
    "PETCTDataset",
    "DEFAULT_BUCKETS",
    "pad_tokens",
    "token_buckets_for",
    "batch_items",
]


def voxel_tokens(fmaps: np.ndarray, fmasks: np.ndarray, orig_hw,
                 spatial_res, noise=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The trainer's tokens of one item (the numpy path): (S, h, w, D)
    feature maps and their (S, h, w) masks → the masked voxels'
    descriptors in (h, w, slice) order plus their 3D encoding / 4. Each
    voxel's mm coordinates (x column, y row, z slice, rescaled from the
    feature grid to ``orig_hw``) are centred on the mean over all voxels
    and shifted by ``noise``."""
    s, h_new, w_new, dim = fmaps.shape
    h_orig, w_orig = orig_hw
    ii, jj, kk = np.meshgrid(np.arange(h_new), np.arange(w_new),
                             np.arange(s), indexing="ij")
    x = (jj / w_new) * w_orig * spatial_res[0]
    y = (ii / h_new) * h_orig * spatial_res[1]
    z = kk * spatial_res[2]
    sel = np.transpose(fmasks, (1, 2, 0)).reshape(-1) > 0  # (h, w, s)
    x = (x - x.mean() + noise[0]).reshape(-1)[sel]
    y = (y - y.mean() + noise[1]).reshape(-1)[sel]
    z = (z - z.mean() + noise[2]).reshape(-1)[sel]
    pe = positional_encoding_3d(x, y, z, dim).numpy()
    tok = np.transpose(fmaps, (1, 2, 0, 3)).reshape(-1, dim)[sel]
    return tok + pe / 4.0


def find_divisor(slice_count: int, modality: str) -> int:
    """Window size per modality: 13 for ct/chest, 2 otherwise, clipped to
    the slice index range (at least 1)."""
    desired = 13 if modality in ("ct", "chest") else 2
    return max(1, int(np.clip(desired, 1, slice_count)))


def prepare_windows(df, modality_a: str = "pet", modality_b: str = "ct",
                    whole_volume: bool = False):
    """``patient_id_new`` sub-volume ids: PET rows ``pid:ceil(slice/d)``,
    CT rows duplicated into stride-1 windows ``pid:i`` over slices [i,
    i + window]. ``whole_volume`` makes the window the full slice range."""
    import pandas as pd

    df = df.copy()
    slices_max = df.groupby(["patient_id", "modality"])["slice"].max()
    if whole_volume:
        divisors = {key: int(val) + 1 for key, val in slices_max.items()}
    else:
        divisors = {key: find_divisor(int(val), key[1])
                    for key, val in slices_max.items()}
    df["divisor"] = [divisors[(p, m)]
                     for p, m in zip(df["patient_id"], df["modality"])]
    df["patient_id_new"] = [
        f"{p}:{int(np.ceil(s / d))}"
        for p, s, d in zip(df["patient_id"], df["slice"], df["divisor"])]

    df_pet = df[df["modality"] == modality_a]
    df_ct = df[df["modality"] == modality_b]
    out = []
    for pid, df_patient in df_ct.groupby("patient_id", sort=False):
        window = int(df_patient["divisor"].max())
        slices = np.sort(df_patient["slice"].unique())
        n = len(slices)
        starts = range(0, n - window) if n > window else range(0, 1)
        for sample_i, slice_i in enumerate(starts):
            hi = slice_i + window if n > window else slices.max()
            m = (df_patient["slice"] >= slice_i) & (df_patient["slice"] <= hi)
            chunk = df_patient[m].copy()
            chunk["patient_id_new"] = f"{pid}:{sample_i}"
            out.append(chunk)
    df_ct = pd.concat(out, axis=0) if out else df_ct.iloc[0:0]
    return pd.concat([df_ct, df_pet], axis=0).reset_index(drop=True)


def nearest_resize(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Order-0 resize with half-pixel centers (skimage's convention): the
    image-res masks onto the feature grid."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    yi = np.clip(np.round((np.arange(oh) + 0.5) * h / oh - 0.5), 0, h - 1)
    xi = np.clip(np.round((np.arange(ow) + 0.5) * w / ow - 0.5), 0, w - 1)
    return img[yi.astype(int)[:, None], xi.astype(int)[None, :]]


@dataclasses.dataclass
class TokenItem:
    """One training example before batching."""

    tokens_ct: np.ndarray        # (Lc, D) or conv volume (S, h, w, D)
    tokens_pet: np.ndarray       # (Lp, D) or conv volume
    label_onehot: np.ndarray     # (num_classes,)
    patient_id: str


class PETCTDataset:
    """Masked-token / conv-volume dataset over the feature store, with an
    explicit numpy Generator. Whole-patient HDF5 reads are kept in an LRU
    cache shared by every instance (every fold's train and test datasets
    read the same patients)."""

    _cache = None
    _cache_capacity: int = 128    # (store, patient) entries

    def __init__(self, dataframe, hdf5_ct_path, hdf5_pet_path,
                 modality_a: str = "pet", modality_b: str = "ct",
                 use_augmentation: bool = False, feature_dim: int = 256,
                 arch: str = "transformer", num_classes: int = 2,
                 seed: int = 0, cache_features: bool = True):
        import pandas as pd

        self.arch = arch
        self.feature_dim = feature_dim
        self.num_classes = num_classes
        self.use_augmentation = use_augmentation
        self.modality_a = modality_a
        self.modality_b = modality_b
        self.hdf5_ct_path = hdf5_ct_path
        self.hdf5_pet_path = hdf5_pet_path
        self.rng = np.random.default_rng(seed)
        self.cache_features = cache_features

        df = dataframe
        self.slice_per_modality = df.groupby(
            ["patient_id", "modality"])["slice"].max()
        self.df_ct = df[df["modality"] == modality_b].reset_index(drop=True)
        self.df_pet = df[df["modality"] == modality_a].reset_index(drop=True)
        self.flip_angles = (
            df.groupby(["flip", "angle"], as_index=False).size()
            [["flip", "angle"]].values.tolist())

        if use_augmentation:
            # one entry per patient, repeated 2–8× so an epoch sees several
            # random sub-windows
            per_patient = (
                self.df_ct.assign(
                    _wid=self.df_ct["patient_id_new"]
                    .str.split(":").str[-1].astype(int))
                .sort_values("_wid", ascending=False)
                .groupby("patient_id").first().reset_index())
            n_windows = self.df_ct["patient_id_new"].nunique()
            repeat = int(np.clip(
                np.ceil(n_windows / max(1, len(per_patient))), 2, 8))
            self.items = pd.DataFrame(
                np.repeat(per_patient.values, repeat, axis=0),
                columns=per_patient.columns)
            self.max_window = dict(zip(per_patient["patient_id"],
                                       per_patient["_wid"]))
        else:
            self.items = (self.df_ct.groupby("patient_id_new")
                          [["patient_id", "label"]].first().reset_index())

        self.df_ct = self.df_ct.set_index(
            ["patient_id_new", "angle", "flip"]).sort_index()
        self.df_pet = self.df_pet.set_index(
            ["patient_id", "angle", "flip"]).sort_index()

    def __len__(self):
        return len(self.items)

    def _read_features(self, hdf5_path, patient_id, feature_ids):
        if self.cache_features:
            cls = PETCTDataset
            if cls._cache is None:
                from collections import OrderedDict

                cls._cache = OrderedDict()
            key = (str(hdf5_path), patient_id)
            if key in cls._cache:
                cls._cache.move_to_end(key)
            else:
                cls._cache[key] = feature_store.read_patient_features(
                    hdf5_path, patient_id)
                while len(cls._cache) > cls._cache_capacity:
                    cls._cache.popitem(last=False)
            feats_all, masks_all = cls._cache[key]
        else:
            feats_all, masks_all = feature_store.read_patient_features(
                hdf5_path, patient_id)
        return ([feats_all[i] for i in feature_ids],
                [masks_all[i] for i in feature_ids])

    def _get_features(self, hdf5_path, patient_id, feature_ids, noise,
                      spatial_res):
        """HDF5 maps → tokens (transformer) or a masked volume (conv)."""
        feats, masks = self._read_features(hdf5_path, patient_id,
                                           feature_ids)
        if native.available():
            fstack = np.stack(feats, axis=0).astype(np.float32)
            mstack = np.stack(masks, axis=0).astype(np.float32)
            if self.arch == "conv":
                return native.mask_features(fstack, mstack), None
            return native.pack_tokens(
                fstack, mstack, np.asarray(spatial_res, np.float64),
                np.asarray(noise, np.float64)), None

        fmaps, fmasks = [], []
        h_orig = w_orig = None
        for f, m in zip(feats, masks):
            h_orig, w_orig = m.shape[:2]
            fmaps.append(f)
            fmasks.append(nearest_resize(m.astype(np.float32), f.shape[:2]))
        fmaps = np.stack(fmaps, axis=0)      # (S, h, w, D)
        fmasks = np.stack(fmasks, axis=0)    # (S, h, w)
        if self.arch == "conv":
            return fmaps * fmasks[..., None], fmasks

        return voxel_tokens(fmaps, fmasks, (h_orig, w_orig), spatial_res,
                            noise), None

    def __getitem__(self, idx: int) -> TokenItem:
        row = self.items.iloc[idx]
        patient_id = row["patient_id"]
        label = int(row["label"])

        if self.use_augmentation:
            flip, angle = self.flip_angles[
                int(self.rng.integers(0, len(self.flip_angles)))]
            max_w = int(self.max_window.get(patient_id, 0))
            wid = int(self.rng.integers(0, max_w)) if max_w > 0 else 0
            pid_new = f"{patient_id}:{wid}"
            noise = self.rng.random(3) * 10.0 - 5.0
            scale = float(self.rng.uniform(0.85, 1.15))
        else:
            flip, angle = "None", 0
            pid_new = row["patient_id_new"]
            noise = np.zeros(3)
            scale = 1.0

        # .loc[[key]] keeps a one-row match a DataFrame (one-slice volumes)
        ct_rows = self.df_ct.loc[[(pid_new, angle, flip)]]
        ct_slices = np.asarray(ct_rows["slice"].values)
        lo_i, hi_i = int(ct_slices.argmin()), int(ct_slices.argmax())
        if hi_i == lo_i:
            # the reference's exclusive-end window would take no slice of a
            # one-slice volume: keep the one slice
            hi_i = lo_i + 1
        if self.use_augmentation and len(ct_slices) > 7:
            wsize = int(self.rng.integers(7, len(ct_slices)))
            lo_i = int(self.rng.integers(0, len(ct_slices) - wsize))
            hi_i = lo_i + wsize
        feature_ids = np.asarray(ct_rows["feature_id"].values)[lo_i:hi_i]
        res_ct = np.abs(np.asarray(ct_rows["spatial_res"].values[0])) * scale
        tokens_ct, _ = self._get_features(
            self.hdf5_ct_path, patient_id, feature_ids, noise, res_ct)

        # the PET slice range in proportion to the CT window's
        ct_max = self.slice_per_modality[(patient_id, self.modality_b)]
        frac = ct_slices[lo_i:hi_i] / max(1, ct_max)
        pet_max = self.slice_per_modality[(patient_id, self.modality_a)]
        lo = max(0, int(frac.min() * pet_max))
        hi = min(int(pet_max), int(frac.max() * pet_max))
        pet_rows = self.df_pet.loc[[(patient_id, angle, flip)]]
        pet_sel = pet_rows[(pet_rows["slice"] >= lo)
                           & (pet_rows["slice"] <= hi)]
        res_pet = np.abs(np.asarray(pet_rows["spatial_res"].values[0])) \
            * scale
        tokens_pet, _ = self._get_features(
            self.hdf5_pet_path, patient_id,
            np.asarray(pet_sel["feature_id"].values), noise, res_pet)

        onehot = np.zeros(self.num_classes, np.float32)
        onehot[label] = 1.0
        return TokenItem(tokens_ct, tokens_pet, onehot, patient_id)


# -- batching ---------------------------------------------------------------

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


def token_buckets_for(items, base: Sequence[int] = DEFAULT_BUCKETS):
    """``base`` extended by doubling to cover the longest item (whole-volume
    token sets may pass the 4096 cap)."""
    longest = max((max(it.tokens_ct.shape[0], it.tokens_pet.shape[0])
                   for it in items), default=0)
    buckets = list(base)
    while buckets[-1] < longest:
        buckets.append(buckets[-1] * 2)
    return tuple(buckets)


def pad_tokens(tokens: np.ndarray, buckets: Sequence[int] = DEFAULT_BUCKETS):
    """(L, D) → ((bucket, D), (bucket,) bool mask); an overlong sequence
    keeps the largest bucket's worth, with a warning."""
    n = tokens.shape[0]
    bucket = _bucket(n, buckets)
    if n > bucket:
        warnings.warn(
            f"token sequence of {n} exceeds the largest bucket {bucket}; "
            f"truncating {n - bucket} tokens (pass extended buckets, e.g. "
            "token_buckets_for(items), to keep them)", stacklevel=2)
        tokens = tokens[:bucket]
        n = bucket
    out = np.zeros((bucket, tokens.shape[1]), np.float32)
    out[:n] = tokens
    mask = np.zeros((bucket,), bool)
    mask[:n] = True
    return out, mask


def batch_items(items: Sequence[TokenItem], batch_size: int,
                buckets: Sequence[int] = DEFAULT_BUCKETS,
                fixed_buckets: tuple[int, int] | None = None
                ) -> Iterator[dict]:
    """Padded batches of ``batch_size`` items in order: each modality's
    bucket is the largest its items need (or ``fixed_buckets=(ct,
    pet)``). Conv items (4-D volumes) batch by shape bucket instead."""
    if items and items[0].tokens_ct.ndim == 4:
        yield from _batch_conv_items(items, batch_size)
        return
    for start in range(0, len(items), batch_size):
        chunk = items[start:start + batch_size]
        n = len(chunk)
        if fixed_buckets is not None:
            bucket_ct, bucket_pet = fixed_buckets
        else:
            bucket_ct = max(_bucket(it.tokens_ct.shape[0], buckets)
                            for it in chunk)
            bucket_pet = max(_bucket(it.tokens_pet.shape[0], buckets)
                             for it in chunk)
        d = chunk[0].tokens_ct.shape[-1]
        ct = np.zeros((n, bucket_ct, d), np.float32)
        mct = np.zeros((n, bucket_ct), bool)
        pet = np.zeros((n, bucket_pet, d), np.float32)
        mpet = np.zeros((n, bucket_pet), bool)
        labels = np.zeros((n, chunk[0].label_onehot.shape[0]), np.float32)
        pids = []
        for i, it in enumerate(chunk):
            ct[i], mct[i] = pad_tokens(it.tokens_ct, (bucket_ct,))
            pet[i], mpet[i] = pad_tokens(it.tokens_pet, (bucket_pet,))
            labels[i] = it.label_onehot
            pids.append(it.patient_id)
        yield {"ct": ct, "ct_mask": mct, "pet": pet, "pet_mask": mpet,
               "labels": labels, "patient_ids": pids}


def _conv_bucket(shape) -> tuple[int, int, int]:
    """Shape bucket of a (S, h, w, D) volume: S → a multiple of 2, h and w
    → multiples of 8."""
    s, h, w = shape[0], shape[1], shape[2]
    return (-(-s // 2) * 2, -(-h // 8) * 8, -(-w // 8) * 8)


def _pad_conv(vol: np.ndarray, bucket) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad a (S, h, w, D) volume to *bucket*; returns (vol, mask)."""
    s, h, w = bucket
    out = np.zeros((s, h, w, vol.shape[3]), np.float32)
    out[: vol.shape[0], : vol.shape[1], : vol.shape[2]] = vol
    mask = np.zeros((s, h, w), bool)
    mask[: vol.shape[0], : vol.shape[1], : vol.shape[2]] = True
    return out, mask


def _batch_conv_items(items: Sequence[TokenItem],
                      batch_size: int) -> Iterator[dict]:
    """Group conv volumes by (CT, PET) shape bucket, in order of first
    appearance, and emit padded batches with voxel masks (``ct_vmask``,
    ``pet_vmask``)."""
    groups: dict = {}
    for it in items:
        key = (_conv_bucket(it.tokens_ct.shape),
               _conv_bucket(it.tokens_pet.shape))
        groups.setdefault(key, []).append(it)
    for (bct, bpet), members in groups.items():
        for start in range(0, len(members), batch_size):
            chunk = members[start:start + batch_size]
            n = len(chunk)
            ct = np.zeros((n,) + bct + (chunk[0].tokens_ct.shape[3],),
                          np.float32)
            mct = np.zeros((n,) + bct, bool)
            pet = np.zeros((n,) + bpet + (chunk[0].tokens_pet.shape[3],),
                           np.float32)
            mpet = np.zeros((n,) + bpet, bool)
            labels = np.zeros((n, chunk[0].label_onehot.shape[0]),
                              np.float32)
            pids = []
            for i, it in enumerate(chunk):
                ct[i], mct[i] = _pad_conv(it.tokens_ct, bct)
                pet[i], mpet[i] = _pad_conv(it.tokens_pet, bpet)
                labels[i] = it.label_onehot
                pids.append(it.patient_id)
            yield {"ct": ct, "ct_vmask": mct, "pet": pet, "pet_vmask": mpet,
                   "ct_mask": np.ones((n, 1), bool),
                   "pet_mask": np.ones((n, 1), bool),
                   "labels": labels, "patient_ids": pids}
