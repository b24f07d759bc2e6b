"""End-to-end backbone fine-tuning CLI.

Counterpart of ``vit_deep_radiomics_tpu/cli/finetune.py``: train the ViT
backbone itself, slice-supervised with patient EGFR labels, through
``engine/finetune.py``. It reads the same isotropic-HDF5 + metadata-CSV
contract as the extract CLI; CT slices are HU-windowed, nodule-cropped
(the reference's 2x square-box arithmetic) and resized; the nodule mask
pools the feature grid. Checkpoints are ``model_epoch_NNNN.pt`` files
holding ``{"state_dict", "epoch"}``.

Example (on the GPU; ``--device cpu`` runs the plain PyTorch path)::

    python -m vit_deep_radiomics_tpu_torch.cli.finetune \\
        -h5 data/iso.hdf5 -df data/iso.csv -s models/finetune \\
        --epochs 3 --batch-size 2 --freeze-below 6
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-h5", "--hdf5-path", required=True)
    p.add_argument("-df", "--df-path", required=True,
                   help="metadata CSV (patient_id, egfr, dataset)")
    p.add_argument("-s", "--save-dir", default="models/finetune")
    p.add_argument("--backbone", default="medsam",
                   help="medsam or a DINOv2 config (dinov2_vits14, "
                        "dinov2_vitb14, dinov2_vitl14, dinov2_vitg14)")
    p.add_argument("--modality", default="ct", choices=["ct", "chest"])
    p.add_argument("--datasets", nargs="*",
                   default=["santa_maria", "stanford"])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--freeze-below", type=int, default=0,
                   help="freeze transformer blocks [0, N)")
    p.add_argument("--precision", default="fast",
                   help="fast (bf16) or parity (fp32, TF32 off)")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer state over the data axis (ZeRO-1;"
                        " multi-device, not ported yet: raises)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient microbatching: split each batch into "
                        "N microbatches, average grads, one optimizer "
                        "step")
    p.add_argument("--remat", nargs="?", const="block", default="none",
                   choices=("none", "block", "mlp"),
                   help="rematerialise in the backward: 'block' recomputes"
                        " whole blocks, 'mlp' only the MLP hidden "
                        "activations. Bare --remat means 'block'.")
    p.add_argument("--ct-window", type=float, nargs=2, default=(800, 40),
                   metavar=("WIDTH", "LEVEL"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    # smoke-scale backbone overrides (tests / dry runs)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--num-heads", type=int, default=None)
    p.add_argument("--window-size", type=int, default=None)
    return p


def _resize(img, size, mode):
    """JAX ``jax.image.resize`` semantics: ``linear`` is half-pixel bilinear
    that antialiases when it downsamples; ``nearest`` takes half-pixel
    centres (torch's ``nearest-exact``)."""
    import torch
    import torch.nn.functional as F

    x = torch.as_tensor(img, dtype=torch.float32)[None, None]
    if mode == "linear":
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                          antialias=True)
    else:
        x = F.interpolate(x, size=size, mode="nearest-exact")
    return x[0, 0].numpy()


def _load_samples(args):
    """(backbone cfg, images, masks, labels_onehot) slice-level arrays."""
    import csv
    import dataclasses as dc

    import numpy as np
    import torch

    from ..data.synthetic import read_isotropic_hdf5
    from ..engine.finetune import FineTuneConfig
    from ..ops import preprocess as pp
    from ..ops import roi

    bcfg = FineTuneConfig(backbone=args.backbone).resolve_backbone()
    overrides = {
        k: getattr(args, k) for k in (
            "image_size", "depth", "width", "num_heads", "window_size")
        if getattr(args, k) is not None
    }
    if overrides:
        bcfg = dc.replace(bcfg, **overrides)
    img_size = bcfg.image_size
    grid = img_size // bcfg.patch_size

    with open(args.df_path, newline="") as f:
        meta = [r for r in csv.DictReader(f) if r["dataset"] in args.datasets]
    images, masks, labels = [], [], []
    for row in meta:
        vol, mask, _res = read_isotropic_hdf5(
            args.hdf5_path, row["patient_id"], args.modality)
        w, l = args.ct_window
        norm = pp.apply_window_ct(
            torch.as_tensor(np.asarray(vol, np.float32)), w, l).numpy()
        union = mask.sum(-1) > 0
        if not union.any():
            continue
        xmin, ymin, xmax, ymax = roi.square_crop_box(union, margin=2)
        crop = roi.crop_image(norm, xmin, ymin, xmax, ymax)
        mcrop = roi.crop_image(mask.astype(np.float32),
                               xmin, ymin, xmax, ymax)
        label = int(row["egfr"] == "Mutant")
        for k in range(crop.shape[2]):
            img = _resize(crop[:, :, k], (img_size, img_size), "linear")
            images.append(np.repeat(img[..., None], 3, axis=-1))
            gm = _resize(mcrop[:, :, k], (grid, grid), "nearest")
            masks.append(gm > 0.5)
            labels.append(label)
    images = np.stack(images).astype(np.float32)
    masks = np.stack(masks)
    onehot = np.eye(2, dtype=np.float32)[np.asarray(labels)]
    return bcfg, images, masks, onehot


def save_checkpoint(state_dict: dict, save_dir, epoch: int) -> Path:
    """``model_epoch_NNNN.pt`` with ``{"state_dict", "epoch"}``, written to
    a temporary file and renamed into place."""
    import torch

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / f"model_epoch_{epoch:04d}.pt"
    tmp = path.with_suffix(f".pt.{os.getpid()}.tmp")
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "epoch": epoch}, tmp)
    tmp.replace(path)
    return path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from .. import default_device
    from ..engine.finetune import FineTuneConfig, FineTuner

    if args.zero1:
        raise NotImplementedError(
            "--zero1 is multi-device work, not ported yet (ROADMAP.md "
            "Queue 1 item 10)")
    device = default_device(args.device)
    bcfg, images, masks, onehot = _load_samples(args)
    n = images.shape[0]
    if n < args.batch_size:
        raise SystemExit(
            f"only {n} slices with nodule masks; need at least "
            f"--batch-size ({args.batch_size})")
    print(f"{n} slices, backbone {bcfg.name} @{bcfg.image_size} on {device}")

    cfg = FineTuneConfig(
        backbone=args.backbone, backbone_cfg=bcfg,
        learning_rate=args.lr, freeze_below=args.freeze_below,
        precision=args.precision, remat=args.remat,
        accum_steps=args.accum_steps,
    )
    tuner = FineTuner(cfg, device=device)
    state = tuner.init(seed=args.seed)
    bs = args.batch_size
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        # drop the ragged tail: every step sees a full batch
        batches = (
            (images[idx], masks[idx], onehot[idx])
            for idx in np.array_split(order[: n - n % bs], max(1, n // bs))
            if len(idx) == bs
        )
        state, losses = tuner.fit(state, batches)
        print(f"epoch {epoch}: mean loss {losses.mean():.4f} "
              f"({len(losses)} steps)")
        save_checkpoint(state["model"].state_dict(), args.save_dir, epoch)
    print(f"checkpoints in {args.save_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
