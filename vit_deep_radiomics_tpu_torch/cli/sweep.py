"""The full experiment sweep in one process.

Counterpart of ``vit_deep_radiomics_tpu/cli/sweep.py``: the reference's
grid of 10 trainings (arch × dataset × modality × loss, its
``run_train.sh``), each a ``train_kfold`` on one device::

    python -m vit_deep_radiomics_tpu_torch.cli.sweep [--archs conv] \\
        [--datasets stanford] [--max-epochs 1]

Reads the parquet/HDF5 store and the k-fold YAML (pandas, h5py, yaml).
``--fold-parallel`` trains each experiment's folds in one vmapped step.
"""

from __future__ import annotations

import argparse
import os

# the reference's grid (run_train.sh:4-13)
GRID = (
    ("conv", "stanford", "pet", "focal"),
    ("conv", "stanford", "ct", "focal"),
    ("conv", "santa_maria", "pet", "focal"),
    ("conv", "santa_maria", "ct", "focal"),
    ("transformer", "stanford", "pet", "focal"),
    ("transformer", "stanford", "ct", "focal"),
    ("transformer", "santa_maria", "pet", "focal"),
    ("transformer", "santa_maria", "ct", "focal"),
    ("transformer", "stanford", "petct", "crossmodal"),
    ("transformer", "santa_maria", "petct", "crossmodal"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run the full arch × dataset × modality × loss "
                    "experiment grid in one process")
    p.add_argument("-e", "--experiment", default="petct")
    p.add_argument("-b", "--backbone", default="medsam")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--precision", default="fast")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--datasets", nargs="*", default=None,
                   help="restrict the grid to these datasets")
    p.add_argument("--archs", nargs="*", default=None,
                   help="restrict the grid to these archs")
    p.add_argument("--fold-parallel", action="store_true",
                   help="train each experiment's folds in one vmapped "
                        "lockstep step (engine/foldpar.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import pandas as pd

    from ..engine.train import TrainerConfig, train_kfold
    from ..utils.config import load_conf

    cfg = load_conf()
    feature_dir = os.path.join(args.data_dir, "features")
    df = pd.read_parquet(os.path.join(feature_dir, "petct.parquet"))
    for arch, dataset, modality, loss in GRID:
        if args.datasets and dataset not in args.datasets:
            continue
        if args.archs and arch not in args.archs:
            continue
        modality_b = "chest" if "chest" in modality else "ct"
        tcfg = TrainerConfig(
            arch=arch, modality=modality, loss=loss, dataset=dataset,
            backbone=args.backbone, experiment=args.experiment,
            batch_size=max(1, cfg["models"][arch].get("batch_size", 1)),
            precision=args.precision, max_epochs=args.max_epochs,
            fold_parallel=args.fold_parallel, device=args.device)
        print(f"=== {arch} / {dataset} / {modality} / {loss} ===")
        train_kfold(
            df, cfg, tcfg,
            hdf5_ct_path=os.path.join(
                feature_dir, f"features_masks_{modality_b}.hdf5"),
            hdf5_pet_path=os.path.join(feature_dir,
                                       "features_masks_pet.hdf5"),
            models_dir=args.models_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
