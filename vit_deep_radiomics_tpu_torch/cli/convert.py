"""Checkpoint interchange with the reference's ``.pth`` format.

Counterpart of ``vit_deep_radiomics_tpu/cli/convert.py``: ``to-pth``
writes the classifier weights of a fold checkpoint
(``model_epoch_NNNN.pt``, ``engine/checkpoint.py``) as a bare
reference-named state dict, which the reference's ``load_checkpoint``,
UMAP and evaluation scripts load unchanged (the port's classifiers carry
the reference's names, so no renaming is needed)::

    python -m vit_deep_radiomics_tpu_torch.cli.convert to-pth \\
        models/petct/medsam_transformer_stanford/ct/kfold_0/model_epoch_0007.pt \\
        -o model_epoch_0007.pth
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert checkpoints to the reference .pth format")
    sub = p.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("to-pth",
                        help="fold .pt checkpoint → reference .pth")
    ex.add_argument("checkpoint", help="model_epoch_NNNN.pt path")
    ex.add_argument("-o", "--out", required=True, help="output .pth path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    state = torch.load(args.checkpoint, map_location="cpu",
                       weights_only=True)
    sd = state["params"] if "params" in state else state
    torch.save(dict(sd), args.out)
    print(f"{args.out}: {len(sd)} tensors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
