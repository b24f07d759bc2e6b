"""K-fold training of the downstream nodule classifiers.

Counterpart of ``vit_deep_radiomics_tpu/engine/train.py``:

* :class:`FoldTrainer` — one fold's classifier, AdamW and epoch loop over
  padded token buckets (batch > 1; the reference is locked to batch 1),
* **the virtual batch counts samples**: ``accum = min(ceil(vb / bsz),
  n_batches)`` micro-batches per update, each loss scaled by ``1 / (accum
  · bsz)``, gradients accumulated in fp32, the optimizer firing every
  ``accum`` micro-batches and on the trailing remainder,
* **AdamW** (β 0.9/0.999, ε 1e-8, weight decay 0.01 × param), its lr set
  per epoch by :func:`cosine_lr` (torch ``CosineAnnealingLR(T_max =
  0.8·epochs, eta_min = 1e-4)``); a parameter the step did not reach is
  updated with a zero gradient, as optax updates every leaf,
* dropout draws from one ``torch.Generator`` per epoch, seeded with
  ``seed · 100003 + epoch``,
* ``fast``: bf16 compute, fp32 parameters, tokens moved to the card as
  bf16; ``parity``: fp32 with TF32 off (``Policy.backends``); ``int8``
  raises,
* each epoch's losses and logits stay on the device until the epoch ends
  (one transfer); eval runs under ``torch.no_grad()``,
* :class:`FoldBookkeeping` — the artifact contract: per-epoch report
  JSONs, ``losses.html``, a checkpoint when ``test_auc² · √test_f1`` ≥ the
  running mean, patience early stopping, mid-fold resume.

* ``whole_volume``: one unchunked token set per patient; the token
  buckets of an epoch double past the 4096 cap to cover its longest item,
  so nothing is truncated (JAX's one-device whole-volume mode),
* ``fold_parallel``: :func:`train_kfold` hands over to
  ``engine/foldpar.py::train_kfold_parallel`` (every fold in one vmapped
  step).

:func:`train_fold` and :func:`train_kfold` read the HDF5/parquet store
(pandas, h5py); ``FoldTrainer`` and ``FoldBookkeeping`` need neither. A
mesh (data parallelism, or ring attention over the sequence in
whole-volume mode) is multi-device work and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .. import default_device
from ..analysis import reports
from ..core.precision import Policy, get_policy
from ..data.datasets import DEFAULT_BUCKETS, _bucket, batch_items, \
    token_buckets_for
from ..engine import checkpoint as ckpt
from ..models.classifiers import build_classifier, init_classifier
from ..models.losses import cross_modal_focal_loss, focal_loss

__all__ = ["TrainerConfig", "cosine_lr", "FoldTrainer", "FoldBookkeeping",
           "train_fold", "train_kfold"]

_MULTI_DEVICE = ("is multi-device work, not ported yet (core/mesh.py has "
                 "no port)")
# torch AdamW's settings of JAX's optax chain (the lr is set per epoch)
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.01}
HISTORY_KEYS = ("epoch", "train_loss", "test_loss", "train_auc", "test_auc",
                "train_f1", "test_f1", "target_metric")


@dataclasses.dataclass
class TrainerConfig:
    """Run-level knobs (the reference CLI flags + model-config keys)."""

    arch: str = "transformer"            # 'transformer' | 'conv'
    modality: str = "petct"              # ct/pet/chest/petct/petchest
    loss: str = "crossmodal"             # 'focal' | 'crossmodal'
    dataset: str = "stanford"
    backbone: str = "medsam"
    experiment: str = "petct"
    batch_size: int = 8                  # real on-device batch
    precision: str = "fast"
    seed: int = 0
    focal_alpha: tuple = (0.25, 0.75)
    num_classes: int = 2
    max_epochs: int | None = None        # override cfg num_epochs
    use_sampler: bool = False            # class-balanced resampling
    whole_volume: bool = False           # unchunked volumes, wider buckets
    fold_parallel: bool = False          # every fold in one vmapped step
    device: str | None = None            # None: the card


def cosine_lr(epoch: int, lr0: float, num_epochs: int,
              eta_min: float = 1e-4) -> float:
    """torch ``CosineAnnealingLR(T_max=0.8·num_epochs)`` in closed form,
    periodic beyond T_max like torch."""
    t_max = num_epochs * 0.8
    return eta_min + (lr0 - eta_min) * (
        1 + math.cos(math.pi * epoch / t_max)) / 2


def _patient_weights(patient_ids: Sequence[str]) -> np.ndarray:
    """1/count per patient, so the metrics weigh patients equally."""
    _, inv, counts = np.unique(patient_ids, return_inverse=True,
                               return_counts=True)
    return 1.0 / counts[inv]


def _check_single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"a training mesh {_MULTI_DEVICE}")


class FoldTrainer:
    """One fold: the classifier, AdamW and the epoch loop on one device."""

    def __init__(self, cfg: dict, tcfg: TrainerConfig, mesh=None,
                 modality_a: str = "pet", modality_b: str = "ct"):
        _check_single_device(mesh)
        self.cfg, self.tcfg = cfg, tcfg
        self.device = default_device(tcfg.device)
        self.policy: Policy = get_policy(tcfg.precision)
        if self.policy.quantized:
            raise ValueError(
                "int8 is an inference-only policy (round() kills the "
                "gradients); train with 'fast' or 'parity'")
        self.model = build_classifier(
            cfg, tcfg.arch, tcfg.modality, modality_a, modality_b,
            num_classes=tcfg.num_classes, policy=self.policy)
        cfg_model = cfg["models"][tcfg.arch]
        self.lr0 = cfg_model["learning_rate"]
        self.num_epochs = tcfg.max_epochs or cfg_model["num_epochs"]
        self.patience = cfg_model["patience"]
        self.virtual_batch = cfg_model["virtual_batch_size"]
        self.feature_dim = cfg_model["feature_dim"]
        self.optimizer: torch.optim.Optimizer | None = None

    # -- setup ---------------------------------------------------------------

    def init_params(self, state_dict: dict | None = None) -> None:
        """Seeded weights (``tcfg.seed``) or ``state_dict``, moved to the
        device, and a fresh AdamW (optax's adamw: the lr is rewritten per
        epoch)."""
        if state_dict is None:
            init_classifier(self.model, self.tcfg.seed)
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        self.optimizer = torch.optim.AdamW(self.model.parameters(),
                                           lr=self.lr0, **ADAMW)

    def checkpoint_state(self) -> dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict()}

    def load_state(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])

    def _tensor(self, x: np.ndarray, tokens: bool = False) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if tokens and t.dtype == torch.float32:
            # the policy's compute dtype on the host: under `fast` half
            # the bytes cross to the card
            t = t.to(self.policy.compute_dtype)
        return t.to(self.device, non_blocking=True)

    def _model_inputs(self, batch: dict):
        m = self.tcfg.modality
        key = "pet" if m == "pet" else "ct"
        if self.tcfg.arch == "conv":
            kwargs = {}
            if f"{key}_vmask" in batch:
                kwargs["valid_mask"] = self._tensor(batch[f"{key}_vmask"])
            return (self._tensor(batch[key], True),), kwargs
        if m in ("petct", "petchest"):
            return (self._tensor(batch["ct"], True),
                    self._tensor(batch["pet"], True)), {
                "ct_mask": self._tensor(batch["ct_mask"]),
                "pet_mask": self._tensor(batch["pet_mask"])}
        return (self._tensor(batch[key], True),), {
            "token_mask": self._tensor(batch[f"{key}_mask"])}

    def _loss_from_outputs(self, outputs, labels, example_weight):
        alpha = self.tcfg.focal_alpha
        if self.tcfg.loss == "crossmodal":
            return cross_modal_focal_loss(
                outputs[0], outputs[2], outputs[3], labels,
                gamma_bimodal=1.0, gamma_unimodal=2.0, alpha=alpha,
                beta=0.6, example_weight=example_weight)
        return focal_loss(outputs[0], labels, gamma=2.0, alpha=alpha,
                          example_weight=example_weight)

    def step(self, batch: dict, scale: float = 1.0, train: bool = False,
             generator=None):
        """One micro-batch: the loss (times ``scale``) and, under
        ``train``, its backward into ``.grad``; dropout draws from
        ``generator`` when one is given. Returns (scaled loss, joint
        logits), detached."""
        args, kwargs = self._model_inputs(batch)
        labels = self._tensor(batch["labels"])
        weight = batch.get("example_weight")
        if weight is not None:
            weight = self._tensor(weight)
        outputs = self.model(*args, **kwargs, generator=generator)
        loss = self._loss_from_outputs(outputs, labels, weight) * scale
        if train:
            loss.backward()
        return loss.detach(), outputs[0].detach()

    def _apply(self) -> None:
        """The optimizer on the accumulated gradients, then a zeroed
        accumulator; a leaf with no gradient takes a zero one."""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=False)

    # -- epoch loop -----------------------------------------------------------

    def run_epoch(self, batches, epoch: int, train: bool,
                  rng_seed: int = 0):
        """One pass; returns (avg_loss, y_true, y_score, patient_ids)."""
        batches = list(batches)
        bsz = max(1, self.tcfg.batch_size)
        generator, scale, accum = None, 1.0, 1
        if train:
            n_micro = max(1, -(-self.virtual_batch // bsz))
            accum = min(n_micro, max(1, len(batches)))
            scale = 1.0 / (accum * bsz)
            generator = torch.Generator(device=self.device).manual_seed(
                rng_seed * 100003 + epoch)
            lr = cosine_lr(epoch, self.lr0, self.num_epochs)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            # a fresh accumulator each epoch
            self.optimizer.zero_grad(set_to_none=False)
        losses, step_logits, y_true, pids = [], [], [], []
        grad_mode = contextlib.nullcontext() if train else torch.no_grad()
        with self.policy.backends(), grad_mode:
            for i, batch in enumerate(batches):
                loss, logits = self.step(batch, scale, train, generator)
                if train and ((i + 1) % accum == 0 or i + 1 == len(batches)):
                    self._apply()
                losses.append(loss)
                step_logits.append(logits)
                y_true.append(np.argmax(batch["labels"], axis=-1))
                pids.extend(batch["patient_ids"])

        if batches:
            # one transfer each for the epoch's losses and logits
            total_loss = float(torch.stack(losses).sum()) * (
                accum * bsz if train else 1.0)
            lg = torch.cat([x.float() for x in step_logits]).cpu().numpy()
            lg = lg - lg.max(axis=-1, keepdims=True)
            e = np.exp(lg)
            y_score = (e / e.sum(axis=-1, keepdims=True))[:, 1]
            y_true = np.concatenate(y_true)
        else:
            total_loss = 0.0
            y_score = np.empty((0,), np.float32)
            y_true = np.empty((0,), np.int64)
        # per-sample average
        return total_loss / max(1, len(pids)), y_true, y_score, pids


def _draw_train_indices(train_ds, tcfg: TrainerConfig, sampler_rng) -> list:
    """The epoch's item order: a permutation, or class-balanced draws with
    replacement under ``use_sampler``."""
    n = len(train_ds)
    if not tcfg.use_sampler:
        return list(sampler_rng.permutation(n))
    labels = train_ds.items["label"].astype(int).to_numpy()
    _, inv, counts = np.unique(labels, return_inverse=True,
                               return_counts=True)
    weights = 1.0 / counts[inv]
    weights = weights / weights.sum()
    return list(sampler_rng.choice(n, size=n, replace=True, p=weights))


def _bucket_sorted(items):
    """Items ordered by their (CT, PET) token buckets, so batches are
    length-homogeneous and pad little."""
    if not items or items[0].tokens_ct.ndim != 2:
        return items
    return sorted(items, key=lambda it: (
        _bucket(it.tokens_ct.shape[0], DEFAULT_BUCKETS),
        _bucket(it.tokens_pet.shape[0], DEFAULT_BUCKETS)))


def _early_stop_state(targets) -> tuple[float, int]:
    """(best_target, epochs_since_improvement) replayed from a restored
    target-metric history: strict improvement resets the count, ties and
    NaNs add to it."""
    targets = np.asarray(list(targets), np.float64)
    if targets.size == 0:
        return -np.inf, 0
    if not np.any(np.isfinite(targets)):
        return -np.inf, int(targets.size)
    best_idx = int(np.nanargmax(targets))
    return float(targets[best_idx]), int(targets.size) - 1 - best_idx


class FoldBookkeeping:
    """Per-epoch metric history, artifact writes, checkpoint gating and
    early stopping of one fold (target metric AUC²·√F1, a checkpoint when
    it reaches the running mean, strict-improvement patience)."""

    def __init__(self, history: dict, patience: int, save_dir, kfold,
                 dataset: str, writes: bool = True, log=print):
        self.history = history
        self.patience = patience
        self.save_dir = Path(save_dir)
        self.kfold = kfold
        self.dataset = dataset
        self.writes = writes
        self.log = log
        self.best_target, self.since_improve = _early_stop_state(
            history["target_metric"])

    def record_epoch(self, epoch: int, tr_loss, te_loss, tr_rep, te_rep,
                     checkpoint_state) -> bool:
        """Append one epoch; write the report JSONs and ``losses.html``;
        gate an asynchronous checkpoint (``checkpoint_state()`` is called
        only when the gate opens and gives ``{"params", "opt_state"}``);
        return True when patience is spent."""
        if self.writes:
            reports.save_report_json(tr_rep, self.save_dir, "train", epoch)
            reports.save_report_json(te_rep, self.save_dir, "test", epoch)
        self.log(reports.format_report(te_rep))

        target = te_rep["ROC AUC"] ** 2 * math.sqrt(
            te_rep["macro avg"]["f1-score"])
        h = self.history
        h["epoch"].append(epoch)
        h["train_loss"].append(tr_loss)
        h["test_loss"].append(te_loss)
        h["train_auc"].append(tr_rep["ROC AUC"])
        h["test_auc"].append(te_rep["ROC AUC"])
        h["train_f1"].append(tr_rep["macro avg"]["f1-score"])
        h["test_f1"].append(te_rep["macro avg"]["f1-score"])
        h["target_metric"].append(target)

        if self.writes:
            reports.write_metrics_html(
                h, self.save_dir / "losses.html",
                title=f"{self.dataset} fold {self.kfold}")
            # NaN targets (one-class splits) checkpoint anyway, so resume
            # works
            if (not np.isfinite(target)
                    or target >= np.nanmean(h["target_metric"])):
                ckpt.save_checkpoint_async(
                    {**checkpoint_state(), "epoch": epoch, "history": h},
                    self.save_dir, epoch)
        if target > self.best_target:
            self.best_target = target
            self.since_improve = 0
        else:
            self.since_improve += 1
        if self.since_improve >= self.patience:
            self.log(f"early stopping fold {self.kfold} at epoch {epoch}")
            return True
        return False


def train_fold(df_train, df_test, cfg: dict, tcfg: TrainerConfig,
               hdf5_ct_path, hdf5_pet_path, save_dir, kfold, mesh=None,
               modality_a: str = "pet", modality_b: str = "ct",
               resume: bool = True, log=print):
    """Train one fold; returns the per-epoch metric DataFrame."""
    import pandas as pd

    from ..data.datasets import PETCTDataset

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    trainer = FoldTrainer(cfg, tcfg, mesh, modality_a, modality_b)
    ds_kwargs = dict(hdf5_ct_path=hdf5_ct_path, hdf5_pet_path=hdf5_pet_path,
                     modality_a=modality_a, modality_b=modality_b,
                     feature_dim=trainer.feature_dim, arch=tcfg.arch,
                     num_classes=tcfg.num_classes)
    train_ds = PETCTDataset(df_train, use_augmentation=True,
                            seed=tcfg.seed, **ds_kwargs)
    test_ds = PETCTDataset(df_test, use_augmentation=False,
                           seed=tcfg.seed + 1, **ds_kwargs)

    history: dict[str, list] = {k: [] for k in HISTORY_KEYS}
    start_epoch = 0
    trainer.init_params()
    if resume:
        last = ckpt.latest_epoch(save_dir)
        if last is not None:
            state = ckpt.load_checkpoint(save_dir, last,
                                         map_location=trainer.device)
            trainer.load_state(state)
            start_epoch = int(state["epoch"]) + 1
            if "history" in state:
                history = state["history"]
            log(f"resumed fold {kfold} from epoch {last}")

    sampler_rng = np.random.default_rng(tcfg.seed + 17)
    book = FoldBookkeeping(history, trainer.patience, save_dir, kfold,
                           tcfg.dataset, log=log)
    for epoch in range(start_epoch, trainer.num_epochs):
        train_items = _bucket_sorted(
            [train_ds[i]
             for i in _draw_train_indices(train_ds, tcfg, sampler_rng)])
        test_items = _bucket_sorted(
            [test_ds[i] for i in range(len(test_ds))])
        bkw = {}
        if tcfg.whole_volume:
            # unchunked token sets may pass the 4096 cap: wider buckets,
            # not truncated volumes
            bkw["buckets"] = token_buckets_for(train_items + test_items)
        train_batches = list(batch_items(train_items, tcfg.batch_size,
                                         **bkw))
        test_batches = list(batch_items(test_items, tcfg.batch_size, **bkw))

        tr_loss, tr_y, tr_s, tr_pids = trainer.run_epoch(
            train_batches, epoch, train=True, rng_seed=tcfg.seed)
        te_loss, te_y, te_s, te_pids = trainer.run_epoch(
            test_batches, epoch, train=False)
        tr_rep = reports.device_epoch_report(
            tr_y, tr_s, _patient_weights(tr_pids), kfold=kfold,
            loss=tr_loss, epoch=epoch, split="train", device=trainer.device)
        te_rep = reports.device_epoch_report(
            te_y, te_s, _patient_weights(te_pids), kfold=kfold,
            loss=te_loss, epoch=epoch, split="test", device=trainer.device)
        if book.record_epoch(epoch, tr_loss, te_loss, tr_rep, te_rep,
                             trainer.checkpoint_state):
            break
    ckpt.wait_pending()
    return pd.DataFrame(history)


def train_kfold(df, cfg: dict, tcfg: TrainerConfig, hdf5_ct_path,
                hdf5_pet_path, models_dir, mesh=None,
                folds: Sequence | None = None, log=print) -> dict:
    """Every fold of the generated k-fold YAML
    (``cfg['kfold_patients'][modality_b][dataset]``) in turn, into
    ``models/<experiment>/<backbone>_<arch>_<dataset>/<modality>/
    kfold_k``; under ``tcfg.fold_parallel`` every fold in one lockstep
    step instead (``engine/foldpar.py``)."""
    if tcfg.fold_parallel:
        from .foldpar import train_kfold_parallel

        return train_kfold_parallel(df, cfg, tcfg, hdf5_ct_path,
                                    hdf5_pet_path, models_dir, mesh=mesh,
                                    folds=folds, log=log)
    from ..data.datasets import prepare_windows

    _check_single_device(mesh)
    modality_a = "pet"
    modality_b = "chest" if "chest" in tcfg.modality else "ct"
    df = df.copy()
    df["flip"] = df["flip"].astype(str)
    df = prepare_windows(df, modality_a, modality_b,
                         whole_volume=tcfg.whole_volume)

    fold_map = cfg["kfold_patients"][modality_b][tcfg.dataset]
    folds = folds if folds is not None else list(fold_map.keys())
    base = (Path(models_dir) / tcfg.experiment
            / f"{tcfg.backbone}_{tcfg.arch}_{tcfg.dataset}" / tcfg.modality)
    results = {}
    for kfold in folds:
        train_p = fold_map[kfold]["train"]
        test_p = fold_map[kfold]["test"]
        df_train = df[df["patient_id"].isin(train_p)].reset_index(drop=True)
        df_test = df[df["patient_id"].isin(test_p)].reset_index(drop=True)
        log(f"fold {kfold}: {len(train_p)} train / {len(test_p)} test "
            "patients")
        results[kfold] = train_fold(
            df_train, df_test, cfg, tcfg, hdf5_ct_path, hdf5_pet_path,
            base / f"kfold_{kfold}", kfold, modality_a=modality_a,
            modality_b=modality_b, log=log)
    return results
