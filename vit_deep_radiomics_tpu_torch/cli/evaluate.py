"""Standalone checkpoint evaluation CLI.

Counterpart of ``vit_deep_radiomics_tpu/cli/evaluate.py``: restore a fold
checkpoint (``model_epoch_NNNN.pt``), run deterministic inference over a
patient split, print and optionally write the patient-weighted report
dict the trainer logs per epoch::

    python -m vit_deep_radiomics_tpu_torch.cli.evaluate \\
        -a transformer -d stanford -m petct -l crossmodal -e petct \\
        --fold 0 [--epoch 12] [--split test] [--out report.json]

Reads the parquet/HDF5 store and the k-fold YAML (pandas, h5py, yaml).
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate a trained fold checkpoint on a patient split")
    p.add_argument("-a", "--arch", default="transformer",
                   choices=["transformer", "conv"])
    p.add_argument("-d", "--dataset", default="stanford")
    p.add_argument("-b", "--backbone", default="medsam")
    p.add_argument("-m", "--modality", default="petchest",
                   choices=["ct", "pet", "chest", "petct", "petchest"])
    p.add_argument("-l", "--loss", default="focal",
                   choices=["focal", "crossmodal"])
    p.add_argument("-e", "--experiment", default="petct")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: best saved epoch)")
    p.add_argument("--split", default="test", choices=["train", "test"],
                   help="which side of the fold to evaluate")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--precision", default="parity",
                   help="eval is deterministic; parity (fp32) by default")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--whole-volume", action="store_true",
                   help="evaluate on unchunked whole-volume token sets "
                        "(for checkpoints trained with --whole-volume)")
    p.add_argument("--out", default=None,
                   help="also write the report JSON here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import pandas as pd

    from ..engine import checkpoint as ckpt
    from ..engine.evaluate import evaluate_checkpoint
    from ..engine.train import TrainerConfig
    from ..utils.config import load_conf

    cfg = load_conf()
    modality_b = "chest" if "chest" in args.modality else "ct"
    feature_dir = os.path.join(args.data_dir, "features")
    df = pd.read_parquet(os.path.join(feature_dir, "petct.parquet"))

    fold_map = cfg["kfold_patients"][modality_b][args.dataset]
    fold_entry = fold_map.get(args.fold, fold_map.get(str(args.fold)))
    if fold_entry is None:
        raise SystemExit(f"fold {args.fold} not in the kfold YAML "
                         f"(has {sorted(fold_map)})")
    df_split = df[df["patient_id"].isin(fold_entry[args.split])]
    if df_split.empty:
        raise SystemExit(
            f"fold {args.fold} {args.split} split has no rows in "
            f"petct.parquet (dataset {args.dataset})")

    fold_dir = os.path.join(
        args.models_dir, args.experiment,
        f"{args.backbone}_{args.arch}_{args.dataset}", args.modality,
        f"kfold_{args.fold}")
    epoch = args.epoch
    if epoch is None:
        best = ckpt.best_epochs(fold_dir)
        if not best:
            raise SystemExit(f"no checkpoints under {fold_dir}")
        epoch = best[-1]
    batch_size = (args.batch_size if args.batch_size is not None
                  else cfg["models"][args.arch].get("batch_size", 1))
    tcfg = TrainerConfig(
        arch=args.arch, modality=args.modality, loss=args.loss,
        dataset=args.dataset, backbone=args.backbone,
        experiment=args.experiment, batch_size=max(1, batch_size),
        precision=args.precision, whole_volume=args.whole_volume,
        device=args.device)
    report = evaluate_checkpoint(
        df_split, cfg, tcfg,
        os.path.join(feature_dir, f"features_masks_{modality_b}.hdf5"),
        os.path.join(feature_dir, "features_masks_pet.hdf5"),
        fold_dir, epoch, kfold=args.fold, split=args.split)
    print(json.dumps(report, indent=2, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
