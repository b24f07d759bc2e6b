"""CLI: dense-descriptor extraction sweep on the GPU.

Counterpart of ``vit_deep_radiomics_tpu/cli/extract.py`` for the isotropic
HDF5 source and the MedSAM backbone::

    python -m vit_deep_radiomics_tpu_torch.cli.extract \\
        -mn medsam -h5 data/iso.hdf5 -df data/iso.csv \\
        -f data/features -mod ct --precision fast --device cuda

``--precision`` takes JAX's six names (``fast``/``bf16``, ``parity``/
``fp32``, ``inference``, ``int8``). Under ``int8`` the sweep is preceded by
JAX's guard: the int8 matmul rate is measured against bf16 on the device,
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
                   help="medsam (the DINOv2 backbones are not ported yet)")
    p.add_argument("-mp", "--model-path", default=None,
                   help="MedSAM .pth checkpoint (random init if absent)")
    p.add_argument("--source", default="isotropic",
                   choices=["isotropic", "tfds"],
                   help="volume source; only the isotropic HDF5 is ported")
    p.add_argument("-h5", "--hdf5-path", default=None,
                   help="isotropic-volume HDF5 dataset")
    p.add_argument("-df", "--df-path", default=None,
                   help="patient metadata CSV (patient_id/egfr/dataset)")
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
                   help="backbone input size (default 1024)")
    p.add_argument("--no-flash", action="store_true",
                   help="plain attention instead of the fused kernels")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.source != "isotropic":
        raise NotImplementedError(
            "the tfds source is not ported yet (ROADMAP.md Queue 1 item 4)")
    if not (args.hdf5_path and args.df_path):
        parser.error("--source isotropic requires --hdf5-path and --df-path")
    from ..engine.extract import (
        DenseExtractor,
        ExtractionConfig,
        extract_isotropic_dataset,
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
        slice_batch=args.slice_batch,
        precision=args.precision,
        use_flash=not args.no_flash,
    )
    extractor = DenseExtractor(cfg, device=args.device)
    written = extract_isotropic_dataset(
        args.hdf5_path, args.df_path, args.feature_folder, extractor,
        modalities=("pet", args.modality), datasets=tuple(args.datasets),
        progress=print)
    print(f"wrote {len(written)} patient parquets")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
