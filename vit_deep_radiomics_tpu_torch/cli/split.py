"""Generate the stratified k-fold patient assignment YAML.

Counterpart of ``vit_deep_radiomics_tpu/cli/split.py``::

    python -m vit_deep_radiomics_tpu_torch.cli.split \\
        --feature-dir data/features [--conf-dir conf] [--n-splits 5]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Patient-stratified k-fold split")
    p.add_argument("--feature-dir", default="data/features")
    p.add_argument("--conf-dir", default=None,
                   help="default: <project>/conf")
    p.add_argument("--n-splits", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    import pandas as pd

    from ..data.splits import build_kfold_patients, write_kfold_yaml
    from ..utils.config import get_project_dir

    df = pd.read_parquet(os.path.join(args.feature_dir, "petct.parquet"))
    folds = build_kfold_patients(df, args.n_splits, args.seed)
    conf_dir = args.conf_dir or os.path.join(get_project_dir(), "conf")
    print(f"wrote {write_kfold_yaml(folds, conf_dir)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
