"""CLI: dense-descriptor extraction sweep on the GPU.

Counterpart of ``vit_deep_radiomics_tpu/cli/extract.py`` on one device::

    python -m vit_deep_radiomics_tpu_torch.cli.extract \\
        -mn medsam -h5 data/iso.hdf5 -df data/iso.csv \\
        -f data/features -mod ct --precision fast --device cuda

``-mn`` takes ``medsam`` or ``dinov2_vit{s,b,l,g}14``; a DINOv2 backbone
runs its patch embedding alone at 896 px (``--dinov2-mode patch_embed``,
the reference's mode) or the whole transformer at 518 px (``full``).
``--source tfds`` sweeps tfds patient datasets from ``--data-dir`` instead
of the isotropic HDF5 (it needs ``tensorflow_datasets``). ``--precision``
takes JAX's six names (``fast``/``bf16``, ``parity``/``fp32``,
``inference``, ``int8``). Under ``int8`` the sweep is preceded by JAX's
guard: the int8 matmul rate is measured against bf16 on the device,
printed, and below half the bf16 rate the CLI refuses unless
``VDR_ALLOW_INT8=1``. ``VDR_FUSED_MLP=1`` in the environment runs the
frozen bf16 blocks' LayerNorm → MLP → residual as one kernel (K7);
``--image-size`` sets the backbone's input size (e.g. 768, whose global
layers take K3).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Extract frozen-ViT dense descriptors (PyTorch + CUDA)")
    p.add_argument("-mn", "--model-name", default="medsam",
                   help="medsam or dinov2_vit{s,b,l,g}14")
    p.add_argument("-mp", "--model-path", default=None,
                   help=".pth checkpoint (random init if absent)")
    p.add_argument("--source", default="isotropic",
                   choices=["isotropic", "tfds"],
                   help="volume source: isotropic HDF5 (default) or tfds "
                        "patient datasets (needs tensorflow_datasets)")
    p.add_argument("-h5", "--hdf5-path", default=None,
                   help="isotropic-volume HDF5 dataset "
                        "(required with --source isotropic)")
    p.add_argument("-df", "--df-path", default=None,
                   help="patient metadata CSV (patient_id/egfr/dataset; "
                        "required with --source isotropic)")
    p.add_argument("--data-dir", default=None,
                   help="tfds data_dir (--source tfds)")
    p.add_argument("-f", "--feature-folder",
                   default=os.path.join("data", "features"))
    p.add_argument("-mod", "--modality", default="ct",
                   help="second modality: ct or chest (pet always runs)")
    p.add_argument("--datasets", nargs="*",
                   default=["santa_maria", "stanford"])
    p.add_argument("--precision", default="fast",
                   choices=["fast", "parity", "bf16", "fp32", "inference",
                            "int8"])
    p.add_argument("--slice-batch", type=int, default=4)
    p.add_argument("--image-size", type=int, default=None,
                   help="backbone input size (default 1024 medsam, 896 "
                        "dinov2 patch_embed, 518 dinov2 full)")
    p.add_argument("--dinov2-mode", default="patch_embed",
                   choices=["patch_embed", "full"],
                   help="dinov2 backbones: patch-embedding tokens (the "
                        "reference's mode) or the whole transformer's "
                        "dense tokens")
    p.add_argument("--no-flash", action="store_true",
                   help="plain attention instead of the fused kernels")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.source == "isotropic" and not (args.hdf5_path and args.df_path):
        parser.error("--source isotropic requires --hdf5-path and --df-path")
    from ..engine.extract import (
        DenseExtractor,
        ExtractionConfig,
        extract_isotropic_dataset,
        extract_tfds_dataset,
    )

    if args.precision == "int8":
        # the live guard against an int8 path slower than bf16 (JAX
        # cli/extract.py:88-95), on the device the sweep runs on
        from ..ops.quant import warn_if_int8_emulated

        ratio = warn_if_int8_emulated(device=args.device)
        print(f"int8/bf16 measured matmul rate ratio: {ratio:.2f}")

    cfg = ExtractionConfig(
        model_name=args.model_name,
        model_path=args.model_path,
        image_size=args.image_size,
        dinov2_mode=args.dinov2_mode,
        slice_batch=args.slice_batch,
        precision=args.precision,
        use_flash=not args.no_flash,
    )
    extractor = DenseExtractor(cfg, device=args.device)
    modalities = ("pet", args.modality)
    if args.source == "tfds":
        # the reference's tfds dataset ids end in `_dataset`
        datasets = tuple(d if d.endswith("_dataset") else f"{d}_dataset"
                         for d in args.datasets)
        written = extract_tfds_dataset(
            args.feature_folder, extractor, datasets=datasets,
            data_dir=args.data_dir, modalities=modalities, progress=print)
    else:
        written = extract_isotropic_dataset(
            args.hdf5_path, args.df_path, args.feature_folder, extractor,
            modalities=modalities, datasets=tuple(args.datasets),
            progress=print)
    print(f"wrote {len(written)} patient parquets")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
