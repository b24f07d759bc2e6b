"""The port's fold-parallel trainer (``engine/foldpar.py``) and k-fold
aggregation (``analysis/aggregate.py``) against the JAX package's and
against the port's own sequential trainer.

Tolerances: against JAX (dropout 0, ``parity``, the same initial weights)
per-epoch losses, parameters and eval scores 1e-5, the key third of each
``in_proj_bias`` held to Adam's step bound as in ``test_torch_train.py``;
against the port's sequential ``FoldTrainer`` with dropout on, at aligned
shapes, JAX's own limits for its lockstep (losses rel 2e-4, scores and
parameters rtol 2e-4 / atol 2e-5, JAX ``tests/test_foldpar.py``); the
stacked AdamW against ``torch.optim.AdamW`` 1e-6 relative; a resumed run
against the uninterrupted one 1e-6 / 1e-7 (JAX's); exhausted folds, the
stacked batches and the summary CSV exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from torch_train_store import tiny_cfg, write_store

from vit_deep_radiomics_tpu.analysis import aggregate as jagg
from vit_deep_radiomics_tpu.engine import checkpoint as jckpt
from vit_deep_radiomics_tpu.engine import evaluate as jeval
from vit_deep_radiomics_tpu.engine import foldpar as jfp
from vit_deep_radiomics_tpu.engine import train as jtrain
from vit_deep_radiomics_tpu_torch.analysis import aggregate as tagg
from vit_deep_radiomics_tpu_torch.data import datasets as tds
from vit_deep_radiomics_tpu_torch.engine import checkpoint as tckpt
from vit_deep_radiomics_tpu_torch.engine import evaluate as teval
from vit_deep_radiomics_tpu_torch.engine import foldpar as tfp
from vit_deep_radiomics_tpu_torch.engine import train as ttrain
from vit_deep_radiomics_tpu_torch.models.convert import \
    classifier_params_from_jax

DIM = 16
JAX_ATOL = 1e-5
KEY_BIAS_STEPS = 2.0     # |Δ| per update of each side, in units of lr
SEQ_REL, SEQ_RTOL, SEQ_ATOL = 2e-4, 2e-4, 2e-5
ADAM_RTOL = 1e-6
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7
FAMILIES = {"unimodal": ("ct", "focal"), "bimodal": ("petct", "crossmodal")}


def _items(rng, n, length, tag="p"):
    """Token items of ``length`` CT and PET tokens, labels alternating."""
    out = []
    for i in range(n):
        out.append(tds.TokenItem(
            rng.normal(size=(length, DIM)).astype(np.float32),
            rng.normal(size=(length, DIM)).astype(np.float32),
            np.eye(2, dtype=np.float32)[i % 2], f"{tag}{i}"))
    return out


def _kw(family, **extra):
    modality, loss = FAMILIES[family]
    return dict(arch="transformer", modality=modality, loss=loss,
                batch_size=2, precision="parity", **extra)


def _cfg():
    """``tiny_cfg`` at one layer a modality (each JAX compile is shorter)."""
    cfg = tiny_cfg(dim=DIM, epochs=3)
    layer = {"num_layers": 1, "num_heads": 2, "mlp_ratio": 2}
    cfg["models"]["transformer"].update(ct=layer, pet=layer)
    return cfg


def _host(tree):
    return classifier_params_from_jax(jax.device_get(tree))


def _jax_pair(family, fold_batches):
    """A JAX and a port ParallelFoldTrainer, dropout 0, on the same
    initial weights."""
    cfg = _cfg()
    jp = jfp.ParallelFoldTrainer(cfg, jtrain.TrainerConfig(**_kw(family)),
                                 n_folds=len(fold_batches))
    jp.model = jp.model.clone(dropout_rate=0.0)
    jp.init_stacked(fold_batches[0][0])
    tp = tfp.ParallelFoldTrainer(
        cfg, ttrain.TrainerConfig(**_kw(family, device="cpu")),
        len(fold_batches))
    tp.model.dropout_rate = 0.0
    tp.init_stacked(_host(jax.tree.map(lambda x: x[0], jp.params)))
    return jp, tp


def _check_params(ref: dict, got: dict, key_bias_bound: float,
                  atol: float = JAX_ATOL, rtol: float = 0.0):
    """``got`` within atol + rtol·|ref| of ``ref``; the key third of each
    ``in_proj_bias`` within ``key_bias_bound``."""
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        over = (got[k] - v).abs() - rtol * v.abs()
        if k.endswith("in_proj_bias"):
            q, kk, vv = over.split(DIM)
            assert float(torch.cat([q, vv]).max()) <= atol, k
            assert float((got[k] - v).abs().split(DIM)[1].max()) <= \
                key_bias_bound, k
        else:
            assert float(over.max()) <= atol, k


def test_stack_fold_batches_matches_jax():
    rng = np.random.default_rng(0)
    a = next(tds.batch_items(_items(rng, 2, 10), 2))
    b = next(tds.batch_items(_items(rng, 1, 200, tag="q"), 2))
    c = next(tds.batch_items(_items(rng, 2, 300), 2))
    for batches in ([a, b, None], [None, c, a], [c]):
        ref, ref_real = jfp.stack_fold_batches(batches, 2)
        got, got_real = tfp.stack_fold_batches(batches, 2)
        assert got_real == ref_real
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("family", ["unimodal", "bimodal"])
def test_lockstep_matches_jax(family):
    """Fold 0: 8 items of 40 tokens (4 micro-batches, updates after 2 and
    4); fold 1: 6 items of 200 (3, updates after 2 and the remainder 3),
    so fold 0 pads to fold 1's buckets. Two epochs: each fold's train and
    eval losses, scores and parameters."""
    rng = np.random.default_rng(1)
    fold_batches = [list(tds.batch_items(_items(rng, 8, 40, "a"), 2)),
                    list(tds.batch_items(_items(rng, 6, 200, "b"), 2))]
    jp, tp = _jax_pair(family, fold_batches)
    lr_sum = 0.0
    for epoch in range(2):
        for train in (True, False):
            ref = jp.run_lockstep_epoch(fold_batches, epoch, train)
            got = tp.run_lockstep_epoch(fold_batches, epoch, train)
            for f in range(2):
                assert abs(got[f][0] - ref[f][0]) <= JAX_ATOL, (epoch, f)
                np.testing.assert_array_equal(got[f][1], ref[f][1])
                np.testing.assert_allclose(got[f][2], ref[f][2], rtol=0,
                                           atol=JAX_ATOL)
                assert got[f][3] == ref[f][3]
        lr_sum += 2 * ttrain.cosine_lr(epoch, tp.lr0, tp.num_epochs)
        for f in range(2):
            _check_params(_host(jp.fold_state(f)[0]),
                          tp.fold_state(f)["params"], KEY_BIAS_STEPS * lr_sum)
    assert tp.steps == [4, 4]


def test_lockstep_matches_sequential_with_dropout():
    """Dropout on (the encoders' 0.5, the heads' 0.1), ``parity``, the
    same item lengths in every fold, full batches: each fold's lockstep
    trajectory is its sequential ``FoldTrainer`` run's."""
    cfg = _cfg()
    tcfg = ttrain.TrainerConfig(**_kw("bimodal", device="cpu"))
    rng = np.random.default_rng(2)
    fold_batches = [list(tds.batch_items(_items(rng, 8, 100, "a"), 2)),
                    list(tds.batch_items(_items(rng, 6, 100, "b"), 2))]
    seq = []
    for f in range(2):
        t = ttrain.FoldTrainer(cfg, tcfg)
        t.init_params()
        seq.append(t)
    par = tfp.ParallelFoldTrainer(cfg, tcfg, 2)
    par.init_stacked()
    for epoch in range(2):
        for train in (True, False):
            got = par.run_lockstep_epoch(fold_batches, epoch, train,
                                         rng_seed=tcfg.seed)
            for f, t in enumerate(seq):
                ref = t.run_epoch(fold_batches[f], epoch, train,
                                  rng_seed=tcfg.seed)
                assert got[f][0] == pytest.approx(ref[0], rel=SEQ_REL)
                np.testing.assert_array_equal(got[f][1], ref[1])
                np.testing.assert_allclose(got[f][2], ref[2], rtol=SEQ_RTOL,
                                           atol=SEQ_ATOL)
                assert got[f][3] == ref[3]
    lr_sum = 2 * sum(ttrain.cosine_lr(e, par.lr0, par.num_epochs)
                     for e in range(2))
    for f, t in enumerate(seq):
        _check_params(t.model.state_dict(), par.fold_state(f)["params"],
                      KEY_BIAS_STEPS * lr_sum, atol=SEQ_ATOL, rtol=SEQ_RTOL)


def test_exhausted_fold_state_frozen():
    """A fold with no batch rides along bit for bit; the other moves."""
    cfg = _cfg()
    par = tfp.ParallelFoldTrainer(
        cfg, ttrain.TrainerConfig(**_kw("unimodal", device="cpu")), 2)
    par.init_stacked()
    batches = [list(tds.batch_items(_items(np.random.default_rng(3), 4, 64),
                                    2)), []]
    before = {k: v.clone() for k, v in par.params.items()}
    res = par.run_lockstep_epoch(batches, 0, train=True)
    for k, v in par.params.items():
        assert torch.equal(v[1], before[k][1]), k
        assert torch.equal(par.exp_avg[k][1], torch.zeros_like(v[1])), k
    assert res[1][3] == [] and res[1][0] == 0.0
    assert any(not torch.equal(v[0], before[k][0])
               for k, v in par.params.items())
    assert par.steps == [1, 0] and par.fold_state(1)["opt_state"]["state"] \
        == {}


def test_stacked_adamw_matches_torch_adamw():
    """Three folds, each with its own cadence and learning rates that
    change between applications, one leaf always given a zero gradient:
    parameters, moments and the ``optimizer.state_dict()`` of
    ``fold_state`` against one ``torch.optim.AdamW`` per fold."""
    cfg = _cfg()
    par = tfp.ParallelFoldTrainer(
        cfg, ttrain.TrainerConfig(**_kw("unimodal", device="cpu")), 3)
    par.init_stacked()
    names = list(par.params)
    zero_leaf = names[0]
    refs = []
    for f in range(3):
        leaves = [par.params[k][f].clone().requires_grad_() for k in names]
        refs.append((leaves, torch.optim.AdamW(
            leaves, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=0.01)))
    pattern = [(1, 0, 1), (0, 1, 1), (1, 1, 0), (1, 0, 0), (0, 1, 1)]
    gen = torch.Generator().manual_seed(4)
    accum = {k: torch.zeros_like(v) for k, v in par.params.items()}
    for i, do in enumerate(pattern):
        lr = 1e-3 * (1 + i)
        for k in names:
            g = torch.randn(accum[k].shape, generator=gen)
            if k == zero_leaf:
                g.zero_()
            accum[k] += g
            for f, (leaves, _) in enumerate(refs):
                leaf = leaves[names.index(k)]
                leaf.grad = g[f].clone() if leaf.grad is None \
                    else leaf.grad + g[f]
        par.lr = lr
        par._apply_stacked(accum, lr, [bool(x) for x in do])
        for f, (leaves, opt) in enumerate(refs):
            if do[f]:
                opt.param_groups[0]["lr"] = lr
                opt.step()
                opt.zero_grad(set_to_none=False)
    for f, (leaves, opt) in enumerate(refs):
        state = par.fold_state(f)
        ref_opt = opt.state_dict()
        assert state["opt_state"]["param_groups"][0].keys() == \
            ref_opt["param_groups"][0].keys()
        for i, k in enumerate(names):
            torch.testing.assert_close(state["params"][k], leaves[i].detach(),
                                       rtol=ADAM_RTOL, atol=0)
            assert not accum[k][f].any() if pattern[-1][f] else True
            for key in ("step", "exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(state["opt_state"]["state"][i][key],
                                           ref_opt["state"][i][key],
                                           rtol=ADAM_RTOL, atol=0)


def test_fold_state_continues_in_fold_trainer():
    """``fold_state(f)`` loaded into a sequential ``FoldTrainer`` (weights
    and AdamW state): its eval scores are the lockstep's, and one more
    train epoch there follows the lockstep's next epoch of that fold."""
    cfg = _cfg()
    tcfg = ttrain.TrainerConfig(**_kw("bimodal", device="cpu"))
    rng = np.random.default_rng(5)
    fold_batches = [list(tds.batch_items(_items(rng, 6, 40, "a"), 2)),
                    list(tds.batch_items(_items(rng, 4, 40, "b"), 2))]
    par = tfp.ParallelFoldTrainer(cfg, tcfg, 2)
    par.model.dropout_rate = 0.0
    par.init_stacked()
    par.run_lockstep_epoch(fold_batches, 0, train=True)
    seq = ttrain.FoldTrainer(cfg, tcfg)
    seq.model.dropout_rate = 0.0
    seq.init_params()
    seq.load_state(par.fold_state(1))
    np.testing.assert_allclose(
        seq.run_epoch(fold_batches[1], 0, train=False)[2],
        par.run_lockstep_epoch(fold_batches, 0, train=False)[1][2],
        rtol=0, atol=SEQ_ATOL)
    ref = seq.run_epoch(fold_batches[1], 1, train=True)
    got = par.run_lockstep_epoch(fold_batches, 1, train=True)[1]
    assert got[0] == pytest.approx(ref[0], rel=SEQ_REL)
    lr = ttrain.cosine_lr(1, par.lr0, par.num_epochs)
    _check_params(seq.model.state_dict(), par.fold_state(1)["params"],
                  KEY_BIAS_STEPS * 2 * lr, atol=SEQ_ATOL, rtol=SEQ_RTOL)


def test_refusals():
    cfg = _cfg()
    with pytest.raises(ValueError, match="whole_volume"):
        tfp.ParallelFoldTrainer(cfg, ttrain.TrainerConfig(
            whole_volume=True, device="cpu"), 2)
    cfg["kfold_patients"] = {"ct": {"stanford": {0: {}, 1: {}}}}
    with pytest.raises(ValueError, match="whole_volume"):
        ttrain.train_kfold(None, cfg, ttrain.TrainerConfig(
            whole_volume=True, fold_parallel=True, device="cpu"),
            None, None, None)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tfp.ParallelFoldTrainer(cfg, ttrain.TrainerConfig(device="cpu"), 2,
                                fold_mesh=object())
    with pytest.raises(NotImplementedError, match="multi-device"):
        ttrain.train_kfold(None, cfg, ttrain.TrainerConfig(
            modality="ct", fold_parallel=True, device="cpu"), None, None,
            None, mesh=object())


# -- train_kfold_parallel on the HDF5/parquet store --------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    pytest.importorskip("h5py")
    pytest.importorskip("sklearn")
    root = tmp_path_factory.mktemp("foldpar_store")
    df, h5_ct, h5_pet = write_store(root, n_patients=4, dim=DIM,
                                    slices={"ct": 14, "pet": 3})
    from vit_deep_radiomics_tpu_torch.data import splits

    return {"root": root, "df": df, "ct": h5_ct, "pet": h5_pet,
            "folds": splits.build_kfold_patients(df, n_splits=2)}


def _tcfg(mod, **kw):
    base = dict(arch="transformer", modality="petct", loss="crossmodal",
                batch_size=2, precision="parity", max_epochs=2,
                fold_parallel=True)
    if mod is ttrain:
        base["device"] = "cpu"
    return mod.TrainerConfig(**{**base, **kw})


def _fold_dir(root, k):
    return (root / "petct" / "medsam_transformer_stanford" / "petct"
            / f"kfold_{k}")


def test_train_kfold_parallel_matches_jax(store, tmp_path, monkeypatch):
    """``train_kfold(fold_parallel=True)`` in both packages on the same
    store (dropout 0, the same initial weights): the same files in every
    fold directory (the checkpoint's suffix aside) and a fresh run's
    sweep of an earlier run's files, the same histories within 1e-5;
    a lockstep checkpoint loads into ``FoldTrainer`` and evaluates as
    JAX's does."""
    cfg = tiny_cfg(store["folds"], dim=DIM, epochs=2)
    init = {}
    j_init = jfp.ParallelFoldTrainer.init_stacked

    def jax_init(self, batch):
        self.model = self.model.clone(dropout_rate=0.0)
        j_init(self, batch)
        init["state"] = _host(jax.tree.map(lambda x: x[0], self.params))

    t_init = tfp.ParallelFoldTrainer.init_stacked

    def port_init(self, state_dict=None):
        self.model.dropout_rate = 0.0
        t_init(self, init["state"])

    monkeypatch.setattr(jfp.ParallelFoldTrainer, "init_stacked", jax_init)
    monkeypatch.setattr(tfp.ParallelFoldTrainer, "init_stacked", port_init)
    stale = _fold_dir(tmp_path / "port", 0)
    stale.mkdir(parents=True)
    (stale / "model_epoch_0099.pt").write_bytes(b"stale")
    (stale / "test_metrics_99.json").write_text("{}")
    hist, names = {}, {}
    for label, mod in (("jax", jtrain), ("port", ttrain)):
        hist[label] = mod.train_kfold(
            store["df"], cfg, _tcfg(mod), store["ct"], store["pet"],
            tmp_path / label, folds=[0, 1], log=lambda *_: None)
        base = _fold_dir(tmp_path / label, 0).parent
        names[label] = sorted(
            str(p.relative_to(base)).replace(".msgpack", ".pt")
            for p in base.rglob("*") if p.is_file())
    assert names["jax"] == names["port"]
    assert "foldpar_resume.pt" in names["port"]
    assert "kfold_0/model_epoch_0099.pt" not in names["port"]
    for k in (0, 1):
        for col in ttrain.HISTORY_KEYS:
            np.testing.assert_allclose(
                np.asarray(hist["port"][k][col], np.float64),
                np.asarray(hist["jax"][k][col], np.float64),
                rtol=0, atol=JAX_ATOL, err_msg=f"fold {k} {col}")

    fold = _fold_dir(tmp_path / "port", 1)
    epoch = tckpt.best_epochs(fold)[-1]
    assert jckpt.best_epochs(_fold_dir(tmp_path / "jax", 1))[-1] == epoch
    trainer = ttrain.FoldTrainer(cfg, _tcfg(ttrain))
    trainer.init_params()
    trainer.load_state(tckpt.load_checkpoint(fold, epoch))
    df_test = store["df"][store["df"]["patient_id"].isin(
        store["folds"]["ct"]["stanford"][1]["test"])]
    reps = {label: mod.evaluate_checkpoint(
        df_test, cfg, _tcfg(tr, fold_parallel=False), store["ct"],
        store["pet"], _fold_dir(tmp_path / label, 1), epoch, kfold=1)
        for label, mod, tr in (("jax", jeval, jtrain),
                               ("port", teval, ttrain))}
    assert abs(reps["port"]["loss"] - reps["jax"]["loss"]) <= JAX_ATOL
    assert reps["port"]["ROC AUC"] == pytest.approx(reps["jax"]["ROC AUC"],
                                                    abs=JAX_ATOL)


def test_snapshot_resume_matches_uninterrupted(store, tmp_path,
                                               monkeypatch):
    """A run killed after epoch 1's snapshot and resumed equals the
    uninterrupted 4-epoch run; ``resume=False`` in the killed run's
    directory starts fresh and equals it too."""
    cfg = tiny_cfg(store["folds"], dim=DIM, epochs=4)
    kw = dict(folds=[0, 1], log=lambda *_: None)
    args = (store["df"], cfg, _tcfg(ttrain, max_epochs=4), store["ct"],
            store["pet"])
    full = tfp.train_kfold_parallel(*args, tmp_path / "full", **kw)
    real_save = tfp._save_lockstep_snapshot

    def killing_save(base, epoch, *a, **k):
        real_save(base, epoch, *a, **k)
        if epoch == 1:
            raise KeyboardInterrupt("simulated kill")

    monkeypatch.setattr(tfp, "_save_lockstep_snapshot", killing_save)
    with pytest.raises(KeyboardInterrupt):
        tfp.train_kfold_parallel(*args, tmp_path / "resume", **kw)
    monkeypatch.setattr(tfp, "_save_lockstep_snapshot", real_save)
    tckpt.wait_pending()
    base = _fold_dir(tmp_path / "resume", 0).parent
    assert json.loads((base / "foldpar_resume.json").read_text())[
        "epoch"] == 1
    logs = []
    resumed = tfp.train_kfold_parallel(*args, tmp_path / "resume",
                                       folds=[0, 1], log=logs.append)
    assert any("continuing at epoch 2" in str(s) for s in logs)
    fresh = tfp.train_kfold_parallel(*args, tmp_path / "resume",
                                     resume=False, **kw)
    for run in (resumed, fresh):
        for k in (0, 1):
            assert len(run[k]) == len(full[k]) == 4
            for col in full[k].columns:
                np.testing.assert_allclose(
                    np.asarray(run[k][col], np.float64),
                    np.asarray(full[k][col], np.float64),
                    rtol=RESUME_RTOL, atol=RESUME_ATOL,
                    err_msg=f"fold {k} column {col}")


def test_cli_fold_parallel_whole_volume_and_aggregate(store, tmp_path,
                                                      monkeypatch):
    """On the CPU: ``train --fold-parallel``, ``sweep --fold-parallel``
    (the conv grid on one dataset), ``train --whole-volume``, ``evaluate
    --whole-volume`` on its checkpoint and ``aggregate`` over the models
    they wrote exit 0 with their files."""
    pytest.importorskip("yaml")
    from vit_deep_radiomics_tpu_torch.cli import aggregate as cli_agg
    from vit_deep_radiomics_tpu_torch.cli import evaluate as cli_eval
    from vit_deep_radiomics_tpu_torch.cli import sweep as cli_sweep
    from vit_deep_radiomics_tpu_torch.cli import train as cli_train
    from vit_deep_radiomics_tpu_torch.utils.config import save_yaml

    (tmp_path / ".git").mkdir()
    save_yaml(tiny_cfg(store["folds"], dim=DIM),
              tmp_path / "conf" / "parameters_models.yaml")
    os.makedirs(tmp_path / "data")
    os.symlink(store["root"] / "features", tmp_path / "data" / "features")
    monkeypatch.chdir(tmp_path)
    common = ["--max-epochs", "1", "--precision", "parity", "--device",
              "cpu"]
    assert cli_train.main(["-m", "petct", "-l", "crossmodal",
                           "--fold-parallel"] + common) == 0
    assert cli_sweep.main(["--archs", "conv", "--datasets", "stanford",
                           "--fold-parallel"] + common) == 0
    assert cli_train.main(["-m", "ct", "-e", "wv", "--whole-volume",
                           "--folds", "0"] + common) == 0
    out = tmp_path / "report.json"
    assert cli_eval.main(["-m", "ct", "-e", "wv", "--whole-volume",
                          "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["epoch"] == 0
    models = tmp_path / "models"
    assert (models / "petct" / "medsam_transformer_stanford" / "petct"
            / "foldpar_resume.pt").exists()
    assert (models / "petct" / "medsam_conv_stanford" / "ct" / "kfold_1"
            / "losses.html").exists()
    assert cli_agg.main([]) == 0
    csv = (tmp_path / "metrics" / "petct_metrics_sumary.csv").read_text(
        encoding="utf-8-sig")
    assert "medsam transformer" in csv and "medsam conv" in csv
    assert (tmp_path / "plots" / "training"
            / "medsam_conv_stanford-pet-training_loss.html").exists()


# -- aggregation -------------------------------------------------------------


def _report(rng, kfold):
    def cls():
        return {k: float(rng.uniform(0.2, 0.9))
                for k in ("precision", "recall", "f1-score")}

    return {"0": cls(), "1": cls(), "accuracy": float(rng.uniform(0.4, 1)),
            "ROC AUC": float(rng.uniform(0.4, 1)), "kfold": kfold,
            "loss": float(rng.uniform(0.1, 2)), "epoch": 0, "split": "x"}


def test_aggregate_matches_jax(tmp_path):
    """Two experiments x two modalities x three folds x four epochs of
    report JSONs (one fold missing an epoch's train report): JAX's and
    the port's summary frames, CSV bytes and curve HTMLs are equal."""
    rng = np.random.default_rng(6)
    base = tmp_path / "models" / "petct"
    for exp in ("medsam_transformer_stanford", "medsam_conv_santa_maria"):
        for modality in ("ct", "pet"):
            for k in range(3):
                d = base / exp / modality / f"kfold_{k}"
                d.mkdir(parents=True)
                for epoch in range(4):
                    for split in ("train", "test"):
                        if (k, epoch, split) == (2, 3, "train"):
                            continue
                        (d / f"{split}_metrics_{epoch}.json").write_text(
                            json.dumps(_report(rng, k)))
                (d / "history_0000.json").write_text("{}")
    outs = {}
    for label, mod in (("jax", jagg), ("port", tagg)):
        outs[label] = mod.aggregate_experiments(
            tmp_path / "models", tmp_path / label / "metrics",
            plots_dir=tmp_path / label / "plots")
    import pandas as pd

    pd.testing.assert_frame_equal(outs["port"], outs["jax"])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 9
    assert files == sorted(p.relative_to(tmp_path / "port") for p in
                           (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    df = tagg.collect_fold_metrics(base / "medsam_conv_santa_maria" / "ct")
    pd.testing.assert_frame_equal(
        tagg.best_epochs_per_fold(df), jagg.best_epochs_per_fold(
            jagg.collect_fold_metrics(base / "medsam_conv_santa_maria"
                                      / "ct")))
    assert tagg.geometric_mean(2.0, 4.0, 8.0) == pytest.approx(4.0)
    with pytest.raises(FileNotFoundError):
        tagg.collect_fold_metrics(tmp_path)
