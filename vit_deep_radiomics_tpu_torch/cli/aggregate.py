"""Aggregate the k-fold metric JSONs into the summary CSV.

Counterpart of ``vit_deep_radiomics_tpu/cli/aggregate.py`` (the
reference's ``avg_kfold_metrics.py``)::

    python -m vit_deep_radiomics_tpu_torch.cli.aggregate \\
        [--models-dir models] [--metrics-dir metrics] [--folder petct] \\
        [--plots-dir plots]

Single-process: JAX's multi-process launch (only the primary process
aggregates) waits for the port's multi-device work. Host code (pandas).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Aggregate k-fold metric JSONs")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--metrics-dir", default="metrics")
    p.add_argument("--folder", default="petct",
                   help="experiment folder under models/")
    p.add_argument("--plots-dir", default="plots")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..analysis.aggregate import aggregate_experiments

    out = aggregate_experiments(args.models_dir, args.metrics_dir,
                                folder=args.folder,
                                plots_dir=args.plots_dir)
    print(out.round(3).T)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
