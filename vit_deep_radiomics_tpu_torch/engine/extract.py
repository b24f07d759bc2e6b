"""Dense-descriptor extraction engine, single device, in PyTorch.

Counterpart of ``vit_deep_radiomics_tpu/engine/extract.py``. Per volume:

* the volume goes to the device once and is normalised there,
* every augmentation's flip→rotate→crop→resize is one bilinear gather
  (``ops/sampling.py``),
* the frozen backbone runs on slice batches: SAM ViT-B/16 (MedSAM), its
  attention in the fused CUDA kernels K1 and K2 (at an image size whose
  global grid they refuse, e.g. 768, the global layers in K3), or a DINOv2
  ViT-*/14, either its patch embedding alone at 896 px (``dinov2_mode=
  "patch_embed"``, the reference's mode) or the whole transformer at 518
  px (``"full"``: K2 in kv_len mode over the 1370 tokens padded to 1536);
  under any precision policy: ``fast``/``parity``, ``inference`` (bf16
  parameters after init or load) or ``int8`` (the per-block matmuls in
  K8); ``VDR_FUSED_MLP=1`` runs the frozen bf16 blocks' MLP half in K7,
* only the bucketed ROI crops of the (grid, grid, channels) feature maps
  (SAM 64 x 64 x 256, DINOv2 ``full`` 37 x 37 x width, ``patch_embed`` 64 x
  64 x width) and of the transformed masks come back to the host, in one
  copy each, for the variable-shape crop and the HDF5/parquet store.

Geometry follows the reference crop arithmetic of ``ops/roi.py`` exactly,
so features, masks and metadata line up with the JAX sweep's. Sources: the
isotropic HDF5 (:func:`extract_isotropic_dataset`) and tfds patient
datasets (:func:`extract_tfds_dataset`, ``data/ingest.py``).

Not ported (they raise): device meshes, pipeline extraction and the
multi-process sweep (``core/mesh.py``, ``parallel/pipeline.py`` and
``core/distributed.py`` have no port).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from .. import default_device
from ..core.precision import Policy, get_policy
from ..data import feature_store
from ..data.synthetic import read_isotropic_hdf5
from ..models.convert import load_dinov2_state_dict, load_medsam_state_dict
from ..models.vit import DINOV2_CONFIGS, SAM_VIT_B, ViTDense, ViTDenseConfig
from ..ops import preprocess as pp
from ..ops import roi
from ..ops.sampling import resample_all_augmentations, transform_mask

__all__ = [
    "StageTimes",
    "ExtractionConfig",
    "DenseExtractor",
    "sweep_crop_buckets",
    "extract_isotropic_dataset",
    "extract_tfds_dataset",
]

FLIPS = (None, "horizontal", "vertical")
ANGLES = (0, 45, 90, 135)


class StageTimes(dict):
    """Thread-safe per-stage wall-clock accumulator (seconds): ``read``,
    ``feed``, ``dispatch``, ``collect``, ``write``."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self[stage] = self.get(stage, 0.0) + seconds

    @contextlib.contextmanager
    def timed(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)


def _timed(stats: StageTimes | None, stage: str):
    return stats.timed(stage) if stats is not None \
        else contextlib.nullcontext()


@dataclasses.dataclass
class ExtractionConfig:
    """Extraction run settings (the JAX config's fields that the port
    runs; the ones it does not run yet raise when set)."""

    model_name: str = "medsam"          # 'medsam' | 'dinov2_vit{s,b,l,g}14'
    model_path: str | None = None       # .pth checkpoint (random if None)
    image_size: int | None = None       # default 1024 medsam; dinov2 896
                                        # (patch_embed) or 518 (full)
    dinov2_mode: str = "patch_embed"    # 'patch_embed' (the reference's
                                        # mode) or 'full' (the whole
                                        # transformer's dense tokens)
    slice_batch: int = 4
    precision: str = "fast"
    use_flash: bool = True
    pipeline: bool = False              # not ported: raises when True
    ct_window: tuple[float, float] = (800.0, 40.0)   # (width, level)
    flips: tuple = FLIPS
    angles: tuple = ANGLES
    # CT host→device wire dtype: 'float32' (exact) or 'int16' (fractional
    # HU rounded to the nearest integer on the host, widened to fp32 on the
    # device: half the upload bytes, at most 0.5 HU against the 800 HU
    # window). PET stays float.
    wire_dtype: str = "float32"
    # augmentations per resample group (None: as many as fit ~768 MB)
    aug_group: int | None = None
    # sweep-shared crop-bucket floors (None: per-volume)
    mask_crop_bucket: int | None = None
    feat_crop_bucket: int | None = None
    shared_buckets: bool = True


def sweep_crop_buckets(
    mask_unions: list[tuple[int, int, np.ndarray]],
    angles: tuple,
    grid: int,
    margin: int = 2,
) -> tuple[int, int]:
    """Cross-volume (mask_crop_bucket, feat_crop_bucket) floors.

    For each volume's unrotated slice-union and every ±angle, bound the
    rotated union's bbox, replay the reference crop arithmetic
    (``extract_coords`` shift margin, ``square_crop_box``, image clamp,
    ``scaled_roi_box`` grid rescale) and return the sweep maxima rounded
    up to 16 (JAX engine/extract.py::sweep_crop_buckets)."""
    mb = fb = 16
    for h, w, union in mask_unions:
        ys, xs = np.where(union)
        if ys.size == 0:
            continue
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        py, px = ys - cy, xs - cx
        sweep = {0.0}
        for angle in angles:
            sweep.add(float(angle))
            sweep.add(-float(angle))
        for angle in sweep:
            rad = np.deg2rad(angle)
            c, s = np.cos(rad), np.sin(rad)
            ry = py * c - px * s + cy
            rx = py * s + px * c + cx
            keep = (ry > -1) & (ry < h) & (rx > -1) & (rx < w)
            if not keep.any():
                continue
            ry, rx = ry[keep], rx[keep]
            ymin = int(np.floor(ry.min())) - 1
            ymax = int(np.ceil(ry.max())) + 1
            xmin = int(np.floor(rx.min())) - 1
            xmax = int(np.ceil(rx.max())) + 1
            bh = max(ymax - ymin, margin)
            bw = max(xmax - xmin, margin)
            cs = 2 * max(bh, bw)               # square_crop_box crop_size
            ymid = (ymin + ymax) // 2
            xmid = (xmin + xmax) // 2
            ch = min(ymid + cs + 2, h) - max(ymid - cs - 2, 0)
            cw = min(xmid + cs + 2, w) - max(xmid - cs - 2, 0)
            ch, cw = max(ch, 1), max(cw, 1)
            mb = max(mb, -(-max(ch + 2, cw + 2) // 16) * 16)
            fext = int(np.ceil(max(bh, bw) * grid / min(ch, cw))) + 4
            fb = max(fb, -(-min(fext, grid) // 16) * 16)
    return mb, fb


def _backbone_for(cfg: ExtractionConfig) -> tuple[ViTDenseConfig, bool]:
    """(model config, patch_embed_only) for a reference model name (JAX
    engine/extract.py:274-295): DINOv2 at 896 px in ``patch_embed`` mode,
    at 518 px in ``full`` mode, unless ``image_size`` says otherwise."""
    if cfg.model_name == "medsam":
        return dataclasses.replace(SAM_VIT_B,
                                   image_size=cfg.image_size or 1024), False
    if cfg.model_name in DINOV2_CONFIGS:
        if cfg.dinov2_mode not in ("patch_embed", "full"):
            raise ValueError(f"dinov2_mode must be 'patch_embed' or 'full', "
                             f"got {cfg.dinov2_mode!r}")
        patch_only = cfg.dinov2_mode == "patch_embed"
        image_size = cfg.image_size or (896 if patch_only else 518)
        return dataclasses.replace(DINOV2_CONFIGS[cfg.model_name],
                                   image_size=image_size), patch_only
    raise ValueError(f"unknown model_name {cfg.model_name!r}")


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


class DenseExtractor:
    """Whole-volume dense-descriptor extractor on one device."""

    def __init__(self, config: ExtractionConfig | None = None,
                 state_dict: dict | None = None, rng_seed: int = 0,
                 backbone_cfg: ViTDenseConfig | None = None,
                 device: str | torch.device | None = None, mesh=None):
        """``state_dict`` in the port's (reference PyTorch) names; without
        one, ``config.model_path`` is loaded, else seeded random weights.
        ``backbone_cfg`` replaces the model-name lookup (small test
        models) and runs the whole transformer, as in JAX. ``device``
        defaults to CUDA and raises without a GPU."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh extraction is not ported: core/mesh.py has no port")
        self.device = default_device(device)
        self.config = dataclasses.replace(config) if config is not None \
            else ExtractionConfig()
        if self.config.pipeline:
            raise NotImplementedError(
                "pipeline extraction is not ported: parallel/pipeline.py "
                "has no port")
        if self.config.wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be 'float32' or 'int16', got "
                             f"{self.config.wire_dtype!r}")
        self.policy: Policy = get_policy(self.config.precision)
        if backbone_cfg is not None:
            self.backbone_cfg, patch_only = backbone_cfg, False
        else:
            self.backbone_cfg, patch_only = _backbone_for(self.config)
        if self.policy.quantized and patch_only:
            raise ValueError(
                "int8 applies to the backbone's projection/MLP matmuls; "
                "the dinov2 patch_embed mode has none (one conv) — "
                "extract with 'fast' or 'parity'")
        self.image_size = self.backbone_cfg.image_size
        self.model = ViTDense(self.backbone_cfg, policy=self.policy,
                              use_flash=self.config.use_flash,
                              patch_embed_only=patch_only).eval()
        if state_dict is None and self.config.model_path:
            load = load_medsam_state_dict \
                if self.config.model_name == "medsam" \
                else load_dinov2_state_dict
            state_dict = load(self.config.model_path)
        if state_dict is None:
            self.model.init_random(rng_seed)
        else:
            if patch_only:   # a whole checkpoint: the patch embedding of it
                state_dict = {k: state_dict[k]
                              for k in self.model.state_dict()}
            self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        # optional StageTimes sink for per-stage wall attribution
        self.stats: StageTimes | None = None

    def _normalize(self, vol: np.ndarray, modality: str) -> torch.Tensor:
        """The reference's normalisation, on the device (JAX :418-433):
        medsam CT → HU window (800, 40); DINOv2 CT → HU→RGB / 255, an
        (H, W, S, 3) volume; PET → /max. A CT volume crosses to the
        device as fp32, or under ``wire_dtype='int16'`` as int16 HU
        (fractional HU rounded on the host with ``np.rint``) widened to
        fp32 there."""
        if modality in ("ct", "chest"):
            vol = np.asarray(vol)
            if self.config.wire_dtype == "int16":
                if np.issubdtype(vol.dtype, np.floating):
                    vol = np.rint(vol).astype(np.int16)
            else:
                vol = vol.astype(np.float32, copy=False)
            v = torch.as_tensor(vol, device=self.device).float()
            if self.config.model_name == "medsam":
                width, level = self.config.ct_window
                return pp.apply_window_ct(v, width, level)
            return pp.hu_to_rgb(v).float() / 255.0
        v = torch.as_tensor(np.asarray(vol, np.float32), device=self.device)
        return pp.normalize_pet(v)

    def extract_volume(self, vol: np.ndarray, mask: np.ndarray,
                       modality: str):
        """All augmentations of one volume → (features, masks, meta), in
        the reference feature_id order (flips outer, angles inner, slices
        innermost); meta is (slices, angles, flips)."""
        return self.collect_volume(self.dispatch_volume(vol, mask, modality))

    @torch.no_grad()
    def dispatch_volume(self, vol: np.ndarray, mask: np.ndarray,
                        modality: str) -> dict:
        """Queue the device work of one volume; returns the collect state.
        The one host sync is the (A, h, w) union-mask pull for the boxes."""
        cfg = self.config
        h, w, s = vol.shape
        if not mask.any():
            raise ValueError("empty nodule mask — nothing to extract")
        with _timed(self.stats, "feed"):
            vol_dev = self._normalize(vol, modality)
            mask_dev = torch.as_tensor(np.asarray(mask),
                                       device=self.device).float()
        t_start = time.perf_counter()
        combos = [(flip, angle) for flip in cfg.flips for angle in cfg.angles]
        n_augs = len(combos)
        fhs = [f == "horizontal" for f, _ in combos]
        fvs = [f == "vertical" for f, _ in combos]
        angles = [a for _, a in combos]
        m_rot_all = torch.stack([
            transform_mask(mask_dev, a, fh, fv, (h, w))
            for a, fh, fv in zip(angles, fhs, fvs)])       # (A, h, w, S)
        unions = m_rot_all.any(dim=-1).cpu().numpy()       # (A, h, w)

        meta_slices: list[int] = []
        meta_angles: list[int] = []
        meta_flips: list[str | None] = []
        boxes: list[tuple[int, int, int, int]] = []
        aug_entries: list[tuple | None] = []
        for ci, (flip, angle) in enumerate(combos):
            union = unions[ci]
            if not union.any():
                boxes.append((0, 0, h, w))      # dummy; dropped at collect
                aug_entries.append(None)
                continue
            xmin, ymin, xmax, ymax = roi.square_crop_box(union, margin=2)
            ymin_c, ymax_c = max(0, ymin), min(h, ymax)
            xmin_c, xmax_c = max(0, xmin), min(w, xmax)
            ch, cw = ymax_c - ymin_c, xmax_c - xmin_c
            boxes.append((ymin_c, xmin_c, ch, cw))
            aug_entries.append((union[ymin_c:ymax_c, xmin_c:xmax_c],
                                ymin_c, xmin_c, ch, cw))
            meta_slices.extend(range(s))
            meta_angles.extend([angle] * s)
            meta_flips.extend([flip] * s)
        active = [e for e in aug_entries if e is not None]
        if not active:
            raise ValueError("empty nodule mask — nothing to extract")

        # bucketed mask crops of every augmentation: one device→host copy
        mb_floor = cfg.mask_crop_bucket or 16
        mbh = min(h, max(mb_floor, _ceil16(max(e[3] for e in active))))
        mbw = min(w, max(mb_floor, _ceil16(max(e[4] for e in active))))
        m_y0 = [min(e[1] if e else 0, h - mbh) for e in aug_entries]
        m_x0 = [min(e[2] if e else 0, w - mbw) for e in aug_entries]
        m_crops = torch.stack([
            m_rot_all[ci, y0:y0 + mbh, x0:x0 + mbw]
            for ci, (y0, x0) in enumerate(zip(m_y0, m_x0))])

        # resample + frozen-ViT forward per augmentation group; groups bound
        # the resampled buffer and its bilinear transients to ~768 MB
        itemsize = torch.empty((), dtype=self.policy.compute_dtype) \
            .element_size()
        bytes_per_aug = s * self.image_size ** 2 * (3 * itemsize + 16)
        group = cfg.aug_group or max(
            1, min(n_augs, (768 << 20) // max(1, bytes_per_aug)))
        feat_parts = []
        for g0 in range(0, n_augs, group):
            g1 = min(n_augs, g0 + group)
            chunks = resample_all_augmentations(
                vol_dev, boxes[g0:g1], angles[g0:g1], fhs[g0:g1],
                fvs[g0:g1], (h, w), self.image_size,
                out_dtype=self.policy.compute_dtype,
                slice_batch=cfg.slice_batch)
            outs = [self.model(chunks[i]) for i in range(chunks.shape[0])]
            feat_parts.append(torch.cat(outs)[: (g1 - g0) * s])
        all_feats = torch.cat(feat_parts)             # (A·S, g, g, C)
        grid = all_feats.shape[1]

        # bucketed feature ROI crops: one device→host copy, in the compute
        # dtype (bf16 halves the transfer on the fast path)
        feat_offsets: list[tuple | None] = []
        f_boxes: list[tuple[int, int, int, int]] = []
        for entry in aug_entries:
            if entry is None:
                f_boxes.append((0, 0, grid, grid))
                feat_offsets.append(None)
                continue
            xmin, ymin, xmax, ymax = roi.scaled_roi_box(
                (grid, grid), entry[0], margin=1)
            f_boxes.append((ymin, xmin, ymax - ymin, xmax - xmin))
            feat_offsets.append(f_boxes[-1])
        fb = min(grid, max(cfg.feat_crop_bucket or 16, _ceil16(max(
            max(b[2], b[3]) for b, e in zip(f_boxes, aug_entries)
            if e is not None))))
        f_y0 = [min(b[0], grid - fb) for b in f_boxes]
        f_x0 = [min(b[1], grid - fb) for b in f_boxes]
        per_aug = all_feats.reshape((n_augs, s) + tuple(all_feats.shape[1:]))
        crops = torch.stack([
            per_aug[a, :, y0:y0 + fb, x0:x0 + fb]
            for a, (y0, x0) in enumerate(zip(f_y0, f_x0))
        ]).to(self.policy.compute_dtype)              # (A, S, fb, fb, C)
        if self.stats is not None:
            self.stats.add("dispatch", time.perf_counter() - t_start)
        return {
            "s": s,
            "aug_entries": aug_entries,
            "m_crops": m_crops, "m_y0": m_y0, "m_x0": m_x0,
            "crops": crops, "f_y0": f_y0, "f_x0": f_x0,
            "feat_offsets": feat_offsets,
            "meta": (meta_slices, meta_angles, meta_flips),
        }

    def collect_volume(self, state: dict):
        """Pull a dispatched volume's crops and assemble the outputs."""
        with _timed(self.stats, "collect"):
            s = state["s"]
            m_crops = state["m_crops"].cpu().numpy()
            crops = state["crops"].float().cpu().numpy()
            features_list: list[np.ndarray] = []
            masks_list: list[np.ndarray] = []
            for ci, entry in enumerate(state["aug_entries"]):
                if entry is None:
                    continue
                union_crop, ymin_c, xmin_c, ch, cw = entry
                oym = ymin_c - state["m_y0"][ci]
                oxm = xmin_c - state["m_x0"][ci]
                m_crop = m_crops[ci][oym:oym + ch, oxm:oxm + cw]
                fy, fx, fh, fw = state["feat_offsets"][ci]
                oy = fy - state["f_y0"][ci]
                ox = fx - state["f_x0"][ci]
                for i in range(s):
                    features_list.append(crops[ci, i, oy:oy + fh, ox:ox + fw])
                    masks_list.append(
                        roi.extract_roi(m_crop[:, :, i], union_crop))
            return features_list, masks_list, state["meta"]


def _shared_buckets(hdf5_path, keys, meta, extractor) -> None:
    """Pin sweep-wide crop-bucket floors from a host mask pre-pass."""
    import h5py

    unions: list[tuple[int, int, np.ndarray]] = []
    with h5py.File(hdf5_path, "r") as h5f:
        for key in keys:
            _, pid, _, modality, _ = meta[key]
            grp = h5f.get(f"{pid}_{modality}/mask_exam")
            if grp is None:
                continue
            union = None
            for k in grp:
                m = grp[k][()] != 0
                union = m if union is None else (union | m)
            if union is not None:
                unions.append((union.shape[0], union.shape[1], union))
    if unions:
        cfg = extractor.config
        cfg.mask_crop_bucket, cfg.feat_crop_bucket = sweep_crop_buckets(
            unions, cfg.angles, extractor.backbone_cfg.grid)


def extract_isotropic_dataset(
    hdf5_path: str | os.PathLike,
    metadata_csv: str | os.PathLike,
    feature_folder: str | os.PathLike,
    extractor: DenseExtractor,
    modalities: tuple[str, str] = ("pet", "ct"),
    datasets: Iterable[str] = ("santa_maria", "stanford"),
    progress: Callable[[str], None] | None = None,
) -> list[str]:
    """Sweep the isotropic-HDF5 dataset → per-patient parquet + HDF5 store.

    Patient list from the metadata CSV (label = egfr == 'Mutant'),
    skip-if-parquet-exists resume, one feature store per modality, and a
    persistent work queue (``engine/workqueue.py``) that records per-item
    failures; each patient's HDF5/parquet write runs as the queue's
    deferred finalizer, overlapping the next patient's extraction. Returns
    the written parquet paths."""
    import pandas as pd

    from .workqueue import WorkQueue

    feature_folder = Path(feature_folder)
    df_meta = pd.read_csv(metadata_csv)
    df_meta["label"] = (df_meta["egfr"] == "Mutant").astype(int)
    has_col = f"has_{''.join(modalities)}"
    if has_col in df_meta.columns:
        df_meta = df_meta[df_meta[has_col]]

    items: list[str] = []
    meta: dict[str, tuple] = {}
    for dataset_name in datasets:
        ds_rows = df_meta[df_meta["dataset"] == dataset_name]
        features_dir = feature_folder / f"{dataset_name}_dataset"
        features_dir.mkdir(parents=True, exist_ok=True)
        for _, row in ds_rows.iterrows():
            for modality in modalities:
                key = f"{dataset_name}/{row['patient_id']}/{modality}"
                items.append(key)
                meta[key] = (dataset_name, row["patient_id"],
                             int(row["label"]), modality, features_dir)

    def _paths(key: str) -> tuple[Path, Path]:
        _, pid, _, modality, features_dir = meta[key]
        return (features_dir / f"{pid}_{modality}.parquet",
                feature_folder / f"features_masks_{modality}.hdf5")

    queue = WorkQueue(feature_folder / "extract_queue.json")
    pending = [k for k in items
               if not _paths(k)[0].exists() and k not in queue.done]
    cfg = extractor.config
    if (cfg.shared_buckets and len(pending) > 1
            and cfg.mask_crop_bucket is None
            and cfg.feat_crop_bucket is None):
        try:
            _shared_buckets(hdf5_path, pending, meta, extractor)
        except Exception as exc:  # noqa: BLE001 — the floors are optional
            print(f"# shared-bucket pre-pass skipped: {exc!r}",
                  file=sys.stderr)

    written: list[str] = []
    stats = extractor.stats

    def worker(key: str):
        dataset_name, pid, label, modality, _ = meta[key]
        df_path, h5_path = _paths(key)
        if df_path.exists():
            return None  # idempotent resume
        if progress:
            progress(key)
        with _timed(stats, "read"):
            vol, mask, spatial_res = read_isotropic_hdf5(
                hdf5_path, pid, modality)
        feats, masks, (sl, an, fl) = extractor.extract_volume(
            vol, mask, modality)
        df = feature_store.slice_metadata_frame(
            sl, an, fl, patient_id=pid, label=label, dataset=dataset_name,
            modality=modality, spatial_res=spatial_res)

        def finalize() -> None:
            with _timed(stats, "write"):
                feature_store.save_features(h5_path, feats, masks, pid)
                df.to_parquet(df_path)
            written.append(str(df_path))

        return finalize

    queue.run(items, worker, log=progress or print)
    return written


def extract_tfds_dataset(
    feature_folder: str | os.PathLike,
    extractor: DenseExtractor,
    datasets: Iterable[str] = ("santa_maria_dataset", "stanford_dataset"),
    data_dir: str | os.PathLike | None = None,
    modalities: tuple[str, str] = ("pet", "ct"),
    progress: Callable[[str], None] | None = None,
    loader: Callable | None = None,
    process_grid: tuple[int, int] | None = None,
) -> list[str]:
    """Sweep tfds patient datasets → per-patient parquet + HDF5 store, on
    one device (JAX engine/extract.py::extract_tfds_dataset).

    Per (patient, modality): the slices stacked into a volume, PET divided
    by its liver uptake (``data/ingest.py::samples_to_voxels``); a label
    outside {0, 1} is skipped with a warning, as is an empty nodule mask;
    then the same augmentation sweep, work queue and feature-store writes
    as the isotropic path. ``loader(dataset_name, data_dir)`` returns ``(ds_pet,
    ds_ct, patient_ids)`` with ``ds_X[patient_id]`` an iterable of per-
    slice sample mappings; the default,
    ``data/ingest.py::load_tfds_pair``, needs ``tensorflow_datasets``.
    ``process_grid`` with more than one process raises: the multi-process
    sweep (``core/distributed.py``) has no port."""
    from ..data import ingest
    from .workqueue import WorkQueue

    if process_grid is not None and process_grid[1] > 1:
        raise NotImplementedError(
            "the multi-process sweep is not ported: core/distributed.py "
            "has no port")
    loader = loader or ingest.load_tfds_pair
    feature_folder = Path(feature_folder)

    items: list[str] = []
    meta: dict[str, tuple] = {}
    for dataset_name in datasets:
        ds_pet, ds_ct, patient_ids = loader(dataset_name, data_dir)
        features_dir = feature_folder / dataset_name
        features_dir.mkdir(parents=True, exist_ok=True)
        for pid in patient_ids:
            for modality in modalities:
                key = f"{dataset_name}/{pid}/{modality}"
                items.append(key)
                meta[key] = (dataset_name, pid, modality,
                             ds_pet if modality == "pet" else ds_ct,
                             features_dir)

    written: list[str] = []
    log = progress or print
    stats = extractor.stats

    def worker(key: str):
        dataset_name, pid, modality, source, features_dir = meta[key]
        df_path = features_dir / f"{pid}_{modality}.parquet"
        h5_path = feature_folder / f"features_masks_{modality}.hdf5"
        if df_path.exists():
            return None  # idempotent resume
        if progress:
            progress(key)
        with _timed(stats, "read"):
            vol, mask, labels, spatial_res = ingest.samples_to_voxels(
                source[pid], pet=(modality == "pet"))
        label = int(labels[0])
        if label not in (0, 1):
            log(f"Warning: skip {pid} with label {label}")
            return None
        if not mask.sum(axis=(0, 1)).max():
            log(f"Warning: {pid} has empty mask")
            return None
        feats, masks, (sl, an, fl) = extractor.extract_volume(
            vol, mask, modality)
        df = feature_store.slice_metadata_frame(
            sl, an, fl, patient_id=pid, label=label,
            dataset=dataset_name.replace("_dataset", ""),
            modality=modality, spatial_res=spatial_res)

        def finalize() -> None:
            with _timed(stats, "write"):
                feature_store.save_features(h5_path, feats, masks, pid)
                df.to_parquet(df_path)
            written.append(str(df_path))

        return finalize

    WorkQueue(feature_folder / "extract_queue.json").run(items, worker,
                                                         log=log)
    return written
