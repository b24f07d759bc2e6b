"""K-fold classifier training CLI.

Counterpart of ``vit_deep_radiomics_tpu/cli/train.py`` with its flags and
defaults, on one device (the card unless ``--device cpu``)::

    python -m vit_deep_radiomics_tpu_torch.cli.train \\
        -a transformer -d stanford -m petct -l crossmodal -e petct

It reads ``<data-dir>/features/petct.parquet``, the feature stores beside
it and the merged ``conf/parameters*.yaml`` of the project (the k-fold map
of ``cli/split.py`` included), so it needs pandas, pyarrow, h5py and
yaml. ``--whole-volume`` trains on unchunked volumes (buckets widened
past 4096 tokens), ``--fold-parallel`` every fold in one vmapped step
(``engine/foldpar.py``); ``--data-parallel`` over more than one device is
multi-device work and raises.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train 3D transformer or CNN nodule classifiers (k-fold)")
    p.add_argument("-a", "--arch", default="transformer",
                   choices=["transformer", "conv"])
    p.add_argument("-d", "--dataset", default="stanford",
                   help="stanford or santa_maria")
    p.add_argument("-b", "--backbone", default="medsam")
    p.add_argument("-m", "--modality", default="petchest",
                   choices=["ct", "pet", "chest", "petct", "petchest"])
    p.add_argument("-l", "--loss", default="focal",
                   choices=["focal", "crossmodal"])
    p.add_argument("-e", "--experiment", default="petct")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override config batch size")
    p.add_argument("--precision", default="fast")
    p.add_argument("--folds", nargs="*", type=int, default=None)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training here "
                        "(trace.json, Chrome format)")
    p.add_argument("--use-sampler", action="store_true",
                   help="class-balanced resampling with replacement (the "
                        "reference's WeightedRandomSampler, off by default "
                        "there too)")
    p.add_argument("--whole-volume", action="store_true",
                   help="no slice chunking: one unchunked token set per "
                        "patient, token buckets widened to the longest")
    p.add_argument("--fold-parallel", action="store_true",
                   help="train every fold in one vmapped lockstep step "
                        "(engine/foldpar.py) instead of the sequential "
                        "fold loop; excludes --whole-volume")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard batches over every visible device (a no-op "
                        "on one device; raises on more)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    return p


@contextlib.contextmanager
def _profile(profile_dir):
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import pandas as pd
    import torch

    from ..engine.train import TrainerConfig, train_kfold
    from ..utils.config import load_conf

    if args.data_parallel and args.device != "cpu" \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "data parallelism over several devices is multi-device work, "
            "not ported yet")
    cfg = load_conf()
    modality_b = "chest" if "chest" in args.modality else "ct"
    feature_dir = os.path.join(args.data_dir, "features")
    df = pd.read_parquet(os.path.join(feature_dir, "petct.parquet"))
    batch_size = (args.batch_size if args.batch_size is not None
                  else cfg["models"][args.arch].get("batch_size", 1))
    tcfg = TrainerConfig(
        arch=args.arch, modality=args.modality, loss=args.loss,
        dataset=args.dataset, backbone=args.backbone,
        experiment=args.experiment, batch_size=max(1, batch_size),
        precision=args.precision, max_epochs=args.max_epochs,
        use_sampler=args.use_sampler, whole_volume=args.whole_volume,
        fold_parallel=args.fold_parallel, device=args.device)
    with _profile(args.profile_dir):
        train_kfold(
            df, cfg, tcfg,
            hdf5_ct_path=os.path.join(
                feature_dir, f"features_masks_{modality_b}.hdf5"),
            hdf5_pet_path=os.path.join(feature_dir,
                                       "features_masks_pet.hdf5"),
            models_dir=args.models_dir, folds=args.folds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
