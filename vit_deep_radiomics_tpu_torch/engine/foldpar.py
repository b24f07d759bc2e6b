"""Fold-parallel k-fold training: every fold in one vmapped step.

Counterpart of ``vit_deep_radiomics_tpu/engine/foldpar.py``. The folds'
classifiers are one stack of parameters with a leading fold axis, and
``torch.func`` advances all of them at once:

* one micro-step is ``vmap(grad_and_value(loss))`` over the fold axis,
  with the classifier run by ``functional_call`` on each fold's slice of
  the stack (no Python loop over folds inside a step),
* per-fold optimizer cadence: AdamW (β 0.9/0.999, ε 1e-8, weight decay
  0.01, torch ``AdamW``'s arithmetic) over the stacked state with a step
  count per fold, applied where ``do_apply`` is set (a fold's
  accumulation group ends this step) and a ``torch.where`` keeping every
  other fold's state and accumulator as it was,
* folds with fewer batches this epoch, or early-stopped, ride along on
  zero-weight batches (``example_weight`` 0 rows add exactly 0 to the
  focal losses and gradients), so their state stays bit for bit,
* each step's per-fold batches are stacked on the host to shared shapes
  (token buckets or conv shapes are per-step maxima across folds; the
  models are mask-aware, so extra padding only costs compute),
* dropout: one ``torch.Generator`` per epoch, seeded ``seed · 100003 +
  epoch`` as the sequential trainer's, drawn by ``vmap(...,
  randomness="same")``: one mask of the per-fold shape a call, the same
  for every fold. Where the folds' shapes agree with the sequential
  batches', each fold draws the masks of its sequential run.

``fold_state(f)`` gives ``FoldTrainer.checkpoint_state()``'s shape (a
``state_dict`` and an ``optimizer.state_dict()``), so a lockstep
checkpoint loads into ``FoldTrainer``, ``train_fold``'s resume and
``engine/evaluate.py``. A snapshot of the whole stack is written after
every completed epoch (``foldpar_resume.pt`` by ``torch.save``, and a
``foldpar_resume.json`` sidecar with JAX's keys: epoch, fold keys,
histories, stopped flags and the exact PCG64 states of the samplers and
of each train dataset's ``rng``), and ``resume=True`` continues a killed
run on the uninterrupted trajectory.

One device. A fold mesh (the fold axis sharded over several devices) is
multi-device work and raises; whole-volume mode raises ``ValueError``, as
in JAX. :func:`train_kfold_parallel` reads the HDF5/parquet store
(pandas, h5py); ``ParallelFoldTrainer`` needs neither.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from ..analysis import reports
from ..data.datasets import batch_items
from ..engine import checkpoint as ckpt
from .train import (
    _MULTI_DEVICE,
    ADAMW,
    HISTORY_KEYS,
    FoldBookkeeping,
    FoldTrainer,
    TrainerConfig,
    _bucket_sorted,
    _draw_train_indices,
    _patient_weights,
    cosine_lr,
)

__all__ = ["stack_fold_batches", "ParallelFoldTrainer",
           "train_kfold_parallel"]

def stack_fold_batches(batches: Sequence[dict | None], batch_size: int
                       ) -> tuple[dict, list]:
    """Stack one lockstep step's per-fold batches into (F, ...) arrays.

    Every ndarray key pads to the max shape across folds (batch axis to
    ``batch_size``, token or volume axes to the per-step maxima); bools
    pad False, floats 0. Adds ``example_weight``: 1 for real rows, 0 for
    padding and for folds with no batch this step (``None``).

    Returns ``(stacked, real)``, ``real[f]`` = ``(n_real_rows,
    patient_ids)``.
    """
    template = next(b for b in batches if b is not None)
    keys = [k for k, v in template.items() if isinstance(v, np.ndarray)]
    target: dict[str, tuple] = {}
    for k in keys:
        dims = np.array(template[k].shape, np.int64)
        for b in batches:
            if b is not None:
                dims = np.maximum(dims, np.array(b[k].shape))
        dims[0] = batch_size
        target[k] = tuple(int(d) for d in dims)

    stacked = {k: np.zeros((len(batches),) + target[k], template[k].dtype)
               for k in keys}
    weight = np.zeros((len(batches), batch_size), np.float32)
    real = []
    for f, b in enumerate(batches):
        if b is None:
            real.append((0, []))
            continue
        n = b[keys[0]].shape[0]
        for k in keys:
            arr = b[k]
            stacked[k][(f,) + tuple(slice(0, e) for e in arr.shape)] = arr
        weight[f, :n] = 1.0
        real.append((n, list(b["patient_ids"])))
    stacked["example_weight"] = weight
    return stacked, real


class ParallelFoldTrainer(FoldTrainer):
    """``FoldTrainer`` whose parameters and AdamW state carry a leading
    fold axis (``params``, ``exp_avg``, ``exp_avg_sq``: name → (F, ...)
    tensors; ``steps``: each fold's update count) and whose steps are
    vmapped over it."""

    def __init__(self, cfg: dict, tcfg: TrainerConfig, n_folds: int,
                 modality_a: str = "pet", modality_b: str = "ct",
                 fold_mesh=None):
        if tcfg.whole_volume:
            raise ValueError(
                "fold_parallel does not compose with whole_volume "
                "sequence parallelism; run the sequential trainer")
        if fold_mesh is not None:
            raise NotImplementedError(
                f"a fold mesh (the fold axis over devices) {_MULTI_DEVICE}")
        super().__init__(cfg, tcfg, None, modality_a, modality_b)
        self.n_folds = n_folds
        self.params: dict[str, torch.Tensor] | None = None
        self.exp_avg: dict[str, torch.Tensor] | None = None
        self.exp_avg_sq: dict[str, torch.Tensor] | None = None
        self.steps = [0] * n_folds
        self.lr = self.lr0

    # -- setup ---------------------------------------------------------------

    def init_stacked(self, state_dict: dict | None = None) -> None:
        """Every fold starts from the same weights (``tcfg.seed``, as the
        sequential path's folds do, or ``state_dict``) and zero moments."""
        super().init_params(state_dict)
        n = self.n_folds
        self.params = {k: p.detach()[None].repeat(n, *[1] * p.dim())
                       for k, p in self.model.named_parameters()}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in
                        self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in
                           self.params.items()}
        self.steps = [0] * n

    def fold_state(self, f: int) -> dict:
        """Fold *f* as ``FoldTrainer.checkpoint_state()`` gives it:
        ``{"params": state_dict, "opt_state": optimizer.state_dict()}``
        (torch ``AdamW``'s layout: no per-parameter state before the
        fold's first update)."""
        opt = self.optimizer.state_dict()
        group = {**opt["param_groups"][0], "lr": self.lr}
        state = {}
        if self.steps[f]:
            step = torch.tensor(float(self.steps[f]), dtype=torch.float32)
            state = {i: {"step": step.clone(),
                         "exp_avg": self.exp_avg[k][f].clone(),
                         "exp_avg_sq": self.exp_avg_sq[k][f].clone()}
                     for i, k in enumerate(self.params)}
        return {"params": {k: v[f].clone() for k, v in self.params.items()},
                "opt_state": {"state": state, "param_groups": [group]}}

    # -- vmapped steps -------------------------------------------------------

    def _fold_loss(self, params, inputs, labels, weight, scale,
                   generator=None):
        """One fold's scaled loss and joint logits (the body vmapped over
        the fold axis)."""
        args, kwargs = inputs
        outputs = functional_call(self.model, params, args,
                                  {**kwargs, "generator": generator})
        loss = self._loss_from_outputs(outputs, labels, weight)
        return loss * scale, outputs[0]

    def _apply_stacked(self, grad_accum: dict, lr: float, do_apply) -> None:
        """AdamW on the folds where ``do_apply`` is set, torch ``AdamW``'s
        arithmetic with each fold's own step count; the other folds keep
        their parameters, moments and accumulators. Zeroes the applied
        folds' accumulators."""
        b1, b2 = ADAMW["betas"]
        for f, on in enumerate(do_apply):
            self.steps[f] += int(on)
        steps = [max(s, 1) for s in self.steps]
        dev = self.device
        step_size = torch.tensor([-lr / (1 - b1 ** s) for s in steps],
                                 dtype=torch.float32, device=dev)
        bc2_sqrt = torch.tensor([(1 - b2 ** s) ** 0.5 for s in steps],
                                dtype=torch.float32, device=dev)
        on = torch.tensor(do_apply, device=dev)
        for k, p in self.params.items():
            shape = (-1,) + (1,) * (p.dim() - 1)
            sel = on.view(shape)
            g = grad_accum[k]
            m = torch.lerp(self.exp_avg[k], g, 1 - b1)
            v = torch.addcmul(self.exp_avg_sq[k] * b2, g, g, value=1 - b2)
            denom = (v.sqrt() / bc2_sqrt.view(shape)).add_(ADAMW["eps"])
            new = p * (1 - lr * ADAMW["weight_decay"])
            new = new + step_size.view(shape) * m / denom
            self.params[k] = torch.where(sel, new, p)
            self.exp_avg[k] = torch.where(sel, m, self.exp_avg[k])
            self.exp_avg_sq[k] = torch.where(sel, v, self.exp_avg_sq[k])
            grad_accum[k] = torch.where(sel, torch.zeros_like(g), g)

    # -- lockstep epoch -------------------------------------------------------

    def run_lockstep_epoch(self, fold_batches: Sequence[list], epoch: int,
                           train: bool, rng_seed: int = 0) -> list[tuple]:
        """One epoch of every fold at once; returns the sequential
        ``run_epoch`` tuple ``(avg_loss, y_true, y_score, patient_ids)``
        per fold (a fold with no batch gets empty results)."""
        if len(fold_batches) != self.n_folds:
            raise ValueError(f"{len(fold_batches)} folds of batches for "
                             f"{self.n_folds} folds")
        n_steps = max((len(b) for b in fold_batches), default=0)
        bsz = max(1, self.tcfg.batch_size)
        accum = [1] * self.n_folds
        if train:
            n_micro = max(1, -(-self.virtual_batch // bsz))
            accum = [min(n_micro, max(1, len(b))) for b in fold_batches]
            scale = torch.tensor([1.0 / (a * bsz) for a in accum],
                                 dtype=torch.float32, device=self.device)
            self.lr = lr = cosine_lr(epoch, self.lr0, self.num_epochs)
            generator = torch.Generator(device=self.device).manual_seed(
                rng_seed * 100003 + epoch)
            grad_accum = {k: torch.zeros_like(v)
                          for k, v in self.params.items()}
            step_fn = vmap(grad_and_value(
                lambda p, i, y, w, s: self._fold_loss(p, i, y, w, s,
                                                      generator),
                has_aux=True), randomness="same")
        else:
            step_fn = vmap(self._fold_loss, in_dims=(0, 0, 0, 0, None))

        losses, step_logits, reals = [], [], []
        grad_mode = torch.enable_grad() if train else torch.no_grad()
        with self.policy.backends(), grad_mode:
            for s in range(n_steps):
                stacked, real = stack_fold_batches(
                    [b[s] if s < len(b) else None for b in fold_batches], bsz)
                reals.append(real)
                inputs = self._model_inputs(stacked)
                labels = self._tensor(stacked["labels"])
                weight = self._tensor(stacked["example_weight"])
                if train:
                    grads, (loss, logits) = step_fn(
                        self.params, inputs, labels, weight, scale)
                    for k, g in grads.items():
                        grad_accum[k].add_(g)
                    # a fold fires on its accumulation boundary or its
                    # trailing remainder; exhausted folds never fire
                    do_apply = [s < len(b) and ((s + 1) % a == 0
                                                or s + 1 == len(b))
                                for b, a in zip(fold_batches, accum)]
                    if any(do_apply):
                        self._apply_stacked(grad_accum, lr, do_apply)
                else:
                    loss, logits = step_fn(self.params, inputs, labels,
                                           weight, 1.0)
                losses.append(loss)
                step_logits.append(logits)

        if n_steps:
            # one transfer each for the epoch's losses and logits
            loss_mat = torch.stack(losses).cpu().numpy()            # (S, F)
            logit_mats = torch.stack(step_logits).float().cpu().numpy()
        results = []
        for f, batches in enumerate(fold_batches):
            if not batches:
                results.append((0.0, np.empty((0,), np.int64),
                                np.empty((0,), np.float32), []))
                continue
            pids, y_true, logit_parts = [], [], []
            for s in range(len(batches)):
                n, p = reals[s][f]
                pids.extend(p)
                y_true.append(np.argmax(batches[s]["labels"], axis=-1))
                logit_parts.append(logit_mats[s][f, :n])
            rescale = accum[f] * bsz if train else 1.0
            total_loss = float(loss_mat[:len(batches), f].sum()) * rescale
            lg = np.concatenate(logit_parts, axis=0)
            lg = lg - lg.max(axis=-1, keepdims=True)
            e = np.exp(lg)
            y_score = (e / e.sum(axis=-1, keepdims=True))[:, 1]
            results.append((total_loss / max(1, len(pids)),
                            np.concatenate(y_true), y_score, pids))
        return results


def _snapshot_paths(base: Path) -> tuple[Path, Path]:
    return base / "foldpar_resume.pt", base / "foldpar_resume.json"


def _save_lockstep_snapshot(base: Path, epoch: int, trainer, history,
                            stopped, fold_keys, sampler_rngs,
                            train_dss) -> None:
    """Atomic stacked-state snapshot after epoch *epoch* completes: the
    stacks (parameters, moments, step counts) by ``torch.save``, and a
    JSON sidecar with JAX's keys (the per-fold histories replay the
    patience countdown on restore; the exact PCG64 states make the resumed
    run draw the uninterrupted run's orders and augmentations)."""
    tpath, jpath = _snapshot_paths(base)
    host = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    tmp = tpath.with_suffix(".pt.tmp")
    torch.save({"params": host(trainer.params),
                "opt_state": {"exp_avg": host(trainer.exp_avg),
                              "exp_avg_sq": host(trainer.exp_avg_sq),
                              "steps": list(trainer.steps)}}, tmp)
    tmp.replace(tpath)
    tmp = jpath.with_suffix(".json.tmp")
    with open(tmp, "w") as fh:
        json.dump({
            "epoch": epoch,
            "fold_keys": [str(k) for k in fold_keys],
            "history": {str(k): history[f] for f, k in enumerate(fold_keys)},
            "stopped": list(map(bool, stopped)),
            "sampler_rng": [r.bit_generator.state for r in sampler_rngs],
            "dataset_rng": [ds.rng.bit_generator.state for ds in train_dss],
        }, fh)
    tmp.replace(jpath)


def _load_lockstep_snapshot(base: Path, trainer, fold_keys, sampler_rngs,
                            train_dss):
    """Restore a snapshot if present and for the same folds; None
    otherwise. Returns ``(next_epoch, history, stopped)`` with the
    trainer's stacks replaced and the sampler and dataset RNG streams at
    the killed run's exact states."""
    tpath, jpath = _snapshot_paths(base)
    if not (tpath.exists() and jpath.exists()):
        return None
    with open(jpath) as fh:
        meta = json.load(fh)
    if meta.get("fold_keys") != [str(k) for k in fold_keys]:
        return None                   # another fold selection: start fresh
    state = torch.load(tpath, map_location=trainer.device, weights_only=True)
    trainer.params = state["params"]
    trainer.exp_avg = state["opt_state"]["exp_avg"]
    trainer.exp_avg_sq = state["opt_state"]["exp_avg_sq"]
    trainer.steps = list(state["opt_state"]["steps"])
    for rng, st in zip(sampler_rngs, meta["sampler_rng"]):
        rng.bit_generator.state = st
    for ds, st in zip(train_dss, meta["dataset_rng"]):
        ds.rng.bit_generator.state = st
    history = [meta["history"][str(k)] for k in fold_keys]
    return meta["epoch"] + 1, history, list(meta["stopped"])


def train_kfold_parallel(df, cfg: dict, tcfg: TrainerConfig, hdf5_ct_path,
                         hdf5_pet_path, models_dir, mesh=None,
                         folds: Sequence | None = None, log=print,
                         resume: bool = True) -> dict:
    """:func:`engine.train.train_kfold` with every fold in one lockstep
    vmapped step: the same inputs, outputs and files (per-fold report
    JSONs, ``losses.html``, gated checkpoints, early stopping), plus the
    stacked snapshot after every epoch, which ``resume=True`` continues
    from (``resume=False`` starts fresh). A fresh run first deletes the
    fold directories' checkpoints and report JSONs of an earlier run."""
    import pandas as pd

    from ..data.datasets import PETCTDataset, prepare_windows

    modality_a = "pet"
    modality_b = "chest" if "chest" in tcfg.modality else "ct"
    fold_map = cfg["kfold_patients"][modality_b][tcfg.dataset]
    fold_keys = list(folds) if folds is not None else list(fold_map.keys())
    trainer = ParallelFoldTrainer(cfg, tcfg, len(fold_keys), modality_a,
                                  modality_b, fold_mesh=mesh)
    df = df.copy()
    df["flip"] = df["flip"].astype(str)
    df = prepare_windows(df, modality_a, modality_b,
                         whole_volume=tcfg.whole_volume)
    base = (Path(models_dir) / tcfg.experiment
            / f"{tcfg.backbone}_{tcfg.arch}_{tcfg.dataset}" / tcfg.modality)
    ds_kwargs = dict(hdf5_ct_path=hdf5_ct_path, hdf5_pet_path=hdf5_pet_path,
                     modality_a=modality_a, modality_b=modality_b,
                     feature_dim=trainer.feature_dim, arch=tcfg.arch,
                     num_classes=tcfg.num_classes)
    train_dss, test_dss, save_dirs = [], [], []
    for kfold in fold_keys:
        train_p = fold_map[kfold]["train"]
        test_p = fold_map[kfold]["test"]
        df_train = df[df["patient_id"].isin(train_p)].reset_index(drop=True)
        df_test = df[df["patient_id"].isin(test_p)].reset_index(drop=True)
        log(f"fold {kfold}: {len(train_p)} train / {len(test_p)} test "
            "patients")
        train_dss.append(PETCTDataset(df_train, use_augmentation=True,
                                      seed=tcfg.seed, **ds_kwargs))
        test_dss.append(PETCTDataset(df_test, use_augmentation=False,
                                     seed=tcfg.seed + 1, **ds_kwargs))
        d = base / f"kfold_{kfold}"
        d.mkdir(parents=True, exist_ok=True)
        save_dirs.append(d)
    trainer.init_stacked()

    # one sampler per fold, each seeded as train_fold seeds its own
    sampler_rngs = [np.random.default_rng(tcfg.seed + 17)
                    for _ in fold_keys]
    restored = (_load_lockstep_snapshot(base, trainer, fold_keys,
                                        sampler_rngs, train_dss)
                if resume else None)
    if restored is None:
        # a fresh run: an earlier run's per-epoch files would mix with
        # this run's for latest_epoch/best-epoch readers
        for d in save_dirs:
            for stale in (*d.glob(f"model_epoch_*{ckpt.SUFFIX}"),
                          *d.glob("train_metrics_*.json"),
                          *d.glob("test_metrics_*.json")):
                stale.unlink()
        start_epoch = 0
        history = [{k: [] for k in HISTORY_KEYS} for _ in fold_keys]
        stopped = [False] * len(fold_keys)
    else:
        start_epoch, history, stopped = restored
        log(f"fold-parallel resume: continuing at epoch {start_epoch}")

    books = [FoldBookkeeping(history[f], trainer.patience, save_dirs[f],
                             kfold, tcfg.dataset, log=log)
             for f, kfold in enumerate(fold_keys)]
    for epoch in range(start_epoch, trainer.num_epochs):
        if all(stopped):
            break
        train_fb, test_fb = [], []
        for f in range(len(fold_keys)):
            if stopped[f]:
                train_fb.append([])
                test_fb.append([])
                continue
            items = _bucket_sorted([train_dss[f][i] for i in
                                    _draw_train_indices(train_dss[f], tcfg,
                                                        sampler_rngs[f])])
            t_items = _bucket_sorted([test_dss[f][i]
                                      for i in range(len(test_dss[f]))])
            train_fb.append(list(batch_items(items, tcfg.batch_size)))
            test_fb.append(list(batch_items(t_items, tcfg.batch_size)))

        train_res = trainer.run_lockstep_epoch(train_fb, epoch, train=True,
                                               rng_seed=tcfg.seed)
        test_res = trainer.run_lockstep_epoch(test_fb, epoch, train=False)
        for f, kfold in enumerate(fold_keys):
            if stopped[f]:
                continue
            tr_loss, tr_y, tr_s, tr_pids = train_res[f]
            te_loss, te_y, te_s, te_pids = test_res[f]
            tr_rep = reports.device_epoch_report(
                tr_y, tr_s, _patient_weights(tr_pids), kfold=kfold,
                loss=tr_loss, epoch=epoch, split="train",
                device=trainer.device)
            te_rep = reports.device_epoch_report(
                te_y, te_s, _patient_weights(te_pids), kfold=kfold,
                loss=te_loss, epoch=epoch, split="test",
                device=trainer.device)
            stopped[f] = books[f].record_epoch(
                epoch, tr_loss, te_loss, tr_rep, te_rep,
                lambda f=f: trainer.fold_state(f))
        _save_lockstep_snapshot(base, epoch, trainer, history, stopped,
                                fold_keys, sampler_rngs, train_dss)
    ckpt.wait_pending()
    return {k: pd.DataFrame(history[f]) for f, k in enumerate(fold_keys)}
