"""Merge the per-patient metadata parquets into ``petct.parquet``.

Counterpart of ``vit_deep_radiomics_tpu/cli/merge.py``::

    python -m vit_deep_radiomics_tpu_torch.cli.merge \\
        --feature-dir data/features
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Merge feature metadata parquets")
    p.add_argument("--feature-dir", default="data/features")
    p.add_argument("--datasets", nargs="*",
                   default=["santa_maria_dataset", "stanford_dataset"])
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    from ..data.feature_store import merge_metadata

    df = merge_metadata(args.feature_dir, tuple(args.datasets), args.output)
    print(f"merged {len(df)} rows from {df['patient_id'].nunique()} "
          "patients")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
