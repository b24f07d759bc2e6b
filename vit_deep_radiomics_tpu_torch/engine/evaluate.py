"""Standalone evaluation: a restored checkpoint → a classification report.

Counterpart of ``vit_deep_radiomics_tpu/engine/evaluate.py``:
deterministic inference of a checkpointed classifier over a metadata
frame (no augmentation), returning the patient-weighted report dict the
trainer logs per epoch, on the windows the checkpoint trained on (whole
volumes under ``tcfg.whole_volume``, the buckets widened to the longest
item). Reads the HDF5/parquet store (pandas, h5py).
"""

from __future__ import annotations

from ..analysis import reports
from ..core.precision import get_policy
from ..data.datasets import PETCTDataset, batch_items, prepare_windows, \
    token_buckets_for
from ..engine import checkpoint as ckpt
from ..engine.train import FoldTrainer, TrainerConfig, _patient_weights

__all__ = ["evaluate_checkpoint"]


def evaluate_checkpoint(df, cfg: dict, tcfg: TrainerConfig, hdf5_ct_path,
                        hdf5_pet_path, fold_dir, epoch: int, kfold=0,
                        split: str = "test") -> dict:
    """Report dict of checkpoint ``epoch`` of ``fold_dir`` over *df*."""
    modality_a = "pet"
    modality_b = "chest" if "chest" in tcfg.modality else "ct"
    if get_policy(tcfg.precision).quantized:
        raise ValueError(
            "int8 applies to the dense backbone only; the classifiers "
            "have no quantized matmuls — evaluate with 'parity' or "
            "'fast'")
    trainer = FoldTrainer(cfg, tcfg, None, modality_a, modality_b)
    df = df.copy()
    df["flip"] = df["flip"].astype(str)
    dfw = prepare_windows(df, modality_a, modality_b,
                          whole_volume=tcfg.whole_volume)
    ds = PETCTDataset(dfw, hdf5_ct_path, hdf5_pet_path,
                      use_augmentation=False, modality_a=modality_a,
                      modality_b=modality_b,
                      feature_dim=cfg["models"][tcfg.arch]["feature_dim"],
                      arch=tcfg.arch, num_classes=tcfg.num_classes)
    items = [ds[i] for i in range(len(ds))]
    bkw = {"buckets": token_buckets_for(items)} if tcfg.whole_volume else {}
    batches = list(batch_items(items, tcfg.batch_size, **bkw))
    if not batches:
        raise ValueError(
            f"no evaluable windows for modality '{tcfg.modality}' — the "
            "frame has no rows for its modalities")
    state = ckpt.load_checkpoint(fold_dir, epoch)
    trainer.init_params(state["params"])
    loss, y_true, y_score, pids = trainer.run_epoch(batches, epoch=epoch,
                                                    train=False)
    return reports.device_epoch_report(
        y_true, y_score, _patient_weights(pids), kfold=kfold, loss=loss,
        epoch=epoch, split=split, device=trainer.device)
