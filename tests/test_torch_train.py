"""The port's classifier trainer against the JAX package's: FoldTrainer
trajectories, eval scores, the epoch report, FoldBookkeeping, train_fold's
artifacts and resume, the CLIs, and the refusals.

Tolerances: per-epoch losses and parameters 1e-5 (fp32, dropout 0 on both
sides, the same initial weights); eval softmax scores 1e-5; the report
dicts 1e-6. The key third of each attention's ``in_proj_bias`` has a zero
gradient in exact arithmetic (a bias on every key of a row cancels in the
softmax); both sides feed Adam rounding noise there, which its
normalisation turns into steps of up to about lr, so that slice is held to
the bound of those steps (``KEY_BIAS_STEPS`` × lr × updates) instead.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from torch_train_store import tiny_cfg, write_store

from vit_deep_radiomics_tpu.analysis import reports as jrep
from vit_deep_radiomics_tpu.engine import checkpoint as jckpt
from vit_deep_radiomics_tpu.engine import train as jtrain
from vit_deep_radiomics_tpu_torch.analysis import reports as trep
from vit_deep_radiomics_tpu_torch.engine import checkpoint as tckpt
from vit_deep_radiomics_tpu_torch.engine import train as ttrain
from vit_deep_radiomics_tpu_torch.models.convert import \
    classifier_params_from_jax

DIM = 16
LOSS_ATOL = PARAM_ATOL = SCORE_ATOL = 1e-5
REPORT_ATOL = 1e-6
KEY_BIAS_STEPS = 2.0     # |Δ| per update of each side, in units of lr


def _batches(rng, n, family, bsz=2):
    out = []
    for i in range(n):
        labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, bsz)]
        pids = [f"p{i}_{j}" for j in range(bsz)]
        if family == "conv":
            vol = rng.normal(size=(bsz, 4, 8, 8, DIM)).astype(np.float32)
            vm = np.ones(vol.shape[:4], bool)
            vm[-1, 3:] = False
            out.append({"ct": vol, "ct_vmask": vm, "pet": vol,
                        "pet_vmask": vm, "ct_mask": np.ones((bsz, 1), bool),
                        "pet_mask": np.ones((bsz, 1), bool),
                        "labels": labels, "patient_ids": pids})
            continue
        ct = rng.normal(size=(bsz, 16, DIM)).astype(np.float32)
        mct = np.ones((bsz, 16), bool)
        mct[-1, 9:] = False
        pet = rng.normal(size=(bsz, 8, DIM)).astype(np.float32)
        mpet = np.ones((bsz, 8), bool)
        mpet[0, 5:] = False
        out.append({"ct": ct, "ct_mask": mct, "pet": pet, "pet_mask": mpet,
                    "labels": labels, "patient_ids": pids})
    return out


FAMILIES = {"bimodal": ("transformer", "petct", "crossmodal"),
            "unimodal": ("transformer", "ct", "focal"),
            "conv": ("conv", "ct", "focal")}


def _pair(family, precision="parity", dropout0=True):
    """A JAX and a port FoldTrainer on the same initial weights."""
    arch, modality, loss = FAMILIES[family]
    cfg = tiny_cfg(dim=DIM, epochs=4)
    kw = dict(arch=arch, modality=modality, loss=loss, batch_size=2,
              precision=precision)
    jt = jtrain.FoldTrainer(cfg, jtrain.TrainerConfig(**kw))
    if dropout0:
        jt.model = jt.model.clone(dropout_rate=0.0)
    rng = np.random.default_rng(0)
    jt.init_params(_batches(rng, 1, family)[0])
    tt = ttrain.FoldTrainer(cfg, ttrain.TrainerConfig(**kw, device="cpu"))
    if dropout0:
        tt.model.dropout_rate = 0.0
    tt.init_params(classifier_params_from_jax(jax.device_get(jt.params)))
    return jt, tt


def _port(family, precision="parity"):
    """A port FoldTrainer on seeded weights, dropout 0."""
    arch, modality, loss = FAMILIES[family]
    tt = ttrain.FoldTrainer(tiny_cfg(dim=DIM, epochs=4), ttrain.TrainerConfig(
        arch=arch, modality=modality, loss=loss, batch_size=2,
        precision=precision, device="cpu"))
    tt.model.dropout_rate = 0.0
    tt.init_params()
    return tt


def _key_bias(name):
    return name.endswith("in_proj_bias")


@pytest.mark.parametrize("family", ["bimodal", "unimodal"])
def test_trajectory_matches_jax(family):
    """Two epochs of 5 micro-batches at batch 2, virtual batch 4 (updates
    after micro-batches 2, 4 and the remainder 5): each epoch's loss and
    the parameters after it, then an eval epoch's scores."""
    jt, tt = _pair(family)
    rng = np.random.default_rng(1)
    batches = _batches(rng, 5, family)
    lr_sum = 0.0
    for epoch in range(2):
        jl, jy, js, jp = jt.run_epoch(batches, epoch, train=True)
        tl, ty, ts, tp = tt.run_epoch(batches, epoch, train=True)
        lr_sum += 3 * ttrain.cosine_lr(epoch, tt.lr0, tt.num_epochs)
        assert abs(jl - tl) <= LOSS_ATOL
        np.testing.assert_array_equal(jy, ty)
        assert jp == tp
        ref = classifier_params_from_jax(jax.device_get(jt.params))
        got = tt.model.state_dict()
        assert sorted(ref) == sorted(got)
        for k, v in ref.items():
            gap = (got[k] - v).abs()
            if _key_bias(k):
                q, kk, vv = gap.split(DIM)
                assert float(torch.cat([q, vv]).max()) <= PARAM_ATOL, k
                assert float(kk.max()) <= KEY_BIAS_STEPS * lr_sum, k
            else:
                assert float(gap.max()) <= PARAM_ATOL, k
    jl, jy, js, _ = jt.run_epoch(batches, 2, train=False)
    tl, ty, ts, _ = tt.run_epoch(batches, 2, train=False)
    assert abs(jl - tl) <= LOSS_ATOL
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)


def test_update_cadence_and_moves():
    """The optimizer fires on micro-batches 2 and 4 and on the remainder
    (3 updates an epoch); a parameter no batch reaches still decays."""
    tt = _port("unimodal")
    calls = []
    step = tt.optimizer.step

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    tt.optimizer.step = counted
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    tt.run_epoch(_batches(np.random.default_rng(2), 5, "unimodal"), 0, True)
    assert len(calls) == 3
    assert all(not torch.equal(before[k], v)
               for k, v in tt.model.state_dict().items()
               if k.endswith("weight"))


def test_conv_eval_and_train_epoch():
    """The conv classifier (whose head keeps JAX's fixed dropout 0.1, so
    only eval compares): eval losses and scores equal JAX's; a train epoch
    moves the weights and stays finite."""
    jt, tt = _pair("conv", dropout0=False)
    batches = _batches(np.random.default_rng(3), 3, "conv")
    jl, _, js, _ = jt.run_epoch(batches, 0, train=False)
    tl, _, ts, _ = tt.run_epoch(batches, 0, train=False)
    assert abs(jl - tl) <= LOSS_ATOL
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)
    loss, *_ = tt.run_epoch(batches, 0, train=True, rng_seed=1)
    assert np.isfinite(loss)


def test_fast_epoch_runs_in_bf16():
    """``fast``: bf16 compute, fp32 parameters and gradients."""
    tt = _port("bimodal", precision="fast")
    batches = _batches(np.random.default_rng(4), 3, "bimodal")
    args, _ = tt._model_inputs(batches[0])
    assert args[0].dtype == torch.bfloat16
    loss, _, scores, _ = tt.run_epoch(batches, 0, train=True, rng_seed=0)
    assert np.isfinite(loss) and np.isfinite(scores).all()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tt.model.parameters())


def _report_inputs(rng, n, degenerate=False):
    y = rng.integers(0, 2, n)
    if degenerate:
        y[:] = 1
    s = np.round(rng.uniform(0, 1, n) * 8) / 8
    pids = [f"p{i % (n // 2)}" for i in range(n)]
    return y, s.astype(np.float32), jtrain._patient_weights(pids)


def _same_report(ref, got):
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        if isinstance(v, dict):
            _same_report(v, got[k])
        elif isinstance(v, float):
            if np.isnan(v):
                assert np.isnan(got[k]), k
            else:
                assert abs(v - got[k]) <= REPORT_ATOL, k
        else:
            assert v == got[k], k


@pytest.mark.parametrize("degenerate", [False, True])
def test_device_epoch_report_matches_jax(degenerate):
    y, s, w = _report_inputs(np.random.default_rng(5), 30, degenerate)
    kw = dict(kfold=1, loss=0.25, epoch=3, split="test")
    ref = jrep.device_epoch_report(y, s, w, **kw)
    got = trep.device_epoch_report(y, s, w, **kw, device="cpu")
    _same_report(ref, got)
    assert trep.format_report(got) == jrep.format_report(ref)


def test_epoch_report_sklearn_matches_device():
    pytest.importorskip("sklearn")
    y, s, w = _report_inputs(np.random.default_rng(6), 40)
    kw = dict(kfold=0, loss=1.0, epoch=0, split="train")
    _same_report(trep.epoch_report(y, s, w, **kw),
                 trep.device_epoch_report(y, s, w, **kw, device="cpu"))


def _reports(rng, aucs):
    out = []
    for e, auc in enumerate(aucs):
        f1 = float(rng.uniform(0.3, 0.9))
        rep = {"ROC AUC": auc, "macro avg": {"f1-score": f1},
               "accuracy": 0.5, "split": "test", "epoch": e, "kfold": 0,
               "loss": 0.1}
        out.append(rep)
    return out


def test_bookkeeping_matches_jax(tmp_path):
    """The same reports: the same checkpointed epochs, the same stop
    epoch, byte-equal report JSONs, history JSONs and losses.html."""
    rng = np.random.default_rng(7)
    aucs = [0.5, 0.7, 0.6, float("nan"), 0.8, 0.75, 0.7, 0.72, 0.71]
    reps = _reports(rng, aucs)
    stops = {}
    for name, mod, ck, state in (
            ("jax", jtrain, jckpt,
             lambda: {"params": {"w": np.zeros(2, np.float32)},
                      "opt_state": {"m": np.ones(2, np.float32)}}),
            ("port", ttrain, tckpt,
             lambda: {"params": {"w": torch.zeros(2)},
                      "opt_state": {"m": torch.ones(2)}})):
        hist = {k: [] for k in ttrain.HISTORY_KEYS}
        book = mod.FoldBookkeeping(hist, 3, tmp_path / name, 0, "stanford",
                                   log=lambda *_: None)
        stops[name] = None
        for e, rep in enumerate(reps):
            if book.record_epoch(e, 0.1 * e, 0.2 * e, rep, rep, state):
                stops[name] = e
                break
        ck.wait_pending()
    assert stops["jax"] == stops["port"] is not None
    assert jckpt.best_epochs(tmp_path / "jax") == \
        tckpt.best_epochs(tmp_path / "port")
    jfiles = sorted(p.name.replace(".msgpack", ".pt")
                    for p in (tmp_path / "jax").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in jfiles:
        if not name.endswith(".pt"):
            assert (tmp_path / "jax" / name).read_bytes() == \
                (tmp_path / "port" / name).read_bytes(), name
    epoch = tckpt.latest_epoch(tmp_path / "port")
    state = tckpt.load_checkpoint(tmp_path / "port", epoch)
    assert state["epoch"] == epoch and torch.equal(state["opt_state"]["m"],
                                                   torch.ones(2))
    assert state["history"]["epoch"] == list(range(epoch + 1))


def test_checkpoint_writes_are_atomic_and_ordered(tmp_path):
    t = torch.arange(4.0)
    fut = tckpt.save_checkpoint_async({"params": {"t": t}, "epoch": 2},
                                      tmp_path, 2)
    t.add_(1)                             # the snapshot was taken already
    tckpt.save_checkpoint({"params": {"t": t}, "epoch": 5}, tmp_path, 5)
    assert fut.result().endswith("model_epoch_0002.pt")
    assert tckpt.wait_pending() == [fut.result()]
    assert tckpt.wait_pending() == []
    assert tckpt.best_epochs(tmp_path) == [2, 5]
    assert tckpt.latest_epoch(tmp_path) == 5
    assert tckpt.latest_epoch(tmp_path / "none") is None
    assert torch.equal(tckpt.load_checkpoint(tmp_path, 2)["params"]["t"],
                       torch.arange(4.0))
    assert not list(tmp_path.glob("*.tmp"))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    pytest.importorskip("h5py")
    pytest.importorskip("sklearn")
    root = tmp_path_factory.mktemp("train_store")
    df, h5_ct, h5_pet = write_store(root, n_patients=4, dim=DIM,
                                    slices={"ct": 14, "pet": 3})
    from vit_deep_radiomics_tpu_torch.data import splits

    return {"root": root, "df": df, "ct": h5_ct, "pet": h5_pet,
            "folds": splits.build_kfold_patients(df, n_splits=2)}


def _tcfg(mod, **kw):
    base = dict(arch="transformer", modality="petct", loss="crossmodal",
                batch_size=2, precision="parity", max_epochs=1)
    if mod is ttrain:
        base["device"] = "cpu"
    return mod.TrainerConfig(**{**base, **kw})


def test_train_kfold_files_and_resume(store, tmp_path):
    """One epoch of one fold in each package writes the same file names
    (the checkpoint's suffix aside); a second port run with two epochs
    resumes after the first and completes the history; the checkpoint
    evaluates."""
    cfg = tiny_cfg(store["folds"], dim=DIM)
    names = {}
    for label, mod in (("jax", jtrain), ("port", ttrain)):
        mod.train_kfold(store["df"], cfg, _tcfg(mod), store["ct"],
                        store["pet"], tmp_path / label, folds=[0],
                        log=lambda *_: None)
        fold = (tmp_path / label / "petct" / "medsam_transformer_stanford"
                / "petct" / "kfold_0")
        names[label] = sorted(p.name.replace(".msgpack", ".pt")
                              for p in fold.iterdir())
    assert names["jax"] == names["port"]
    assert "model_epoch_0000.pt" in names["port"]

    logs = []
    hist = ttrain.train_kfold(store["df"], cfg, _tcfg(ttrain, max_epochs=2),
                              store["ct"], store["pet"], tmp_path / "port",
                              folds=[0], log=logs.append)[0]
    assert any("resumed fold 0 from epoch 0" in str(s) for s in logs)
    assert list(hist["epoch"]) == [0, 1]
    assert np.isfinite(hist["train_loss"]).all()

    from vit_deep_radiomics_tpu_torch.engine.evaluate import \
        evaluate_checkpoint

    fold = (tmp_path / "port" / "petct" / "medsam_transformer_stanford"
            / "petct" / "kfold_0")
    df_test = store["df"][store["df"]["patient_id"].isin(
        store["folds"]["ct"]["stanford"][0]["test"])]
    epoch = tckpt.best_epochs(fold)[-1]
    report = evaluate_checkpoint(df_test, cfg, _tcfg(ttrain), store["ct"],
                                 store["pet"], fold, epoch)
    assert report["split"] == "test" and report["epoch"] == epoch
    assert "ROC AUC" in report and "macro avg" in report


def test_cli_train_one_epoch(store, tmp_path, monkeypatch):
    """``cli/train.py --max-epochs 1`` on the CPU exits 0 after ``cli/
    merge.py`` and ``cli/split.py`` built its inputs; ``cli/evaluate.py``
    reads the checkpoint, ``cli/convert.py to-pth`` writes it under the
    reference's names, and ``cli/sweep.py`` runs the conv grid."""
    pytest.importorskip("yaml")
    from vit_deep_radiomics_tpu_torch.cli import evaluate as cli_eval
    from vit_deep_radiomics_tpu_torch.cli import merge as cli_merge
    from vit_deep_radiomics_tpu_torch.cli import split as cli_split
    from vit_deep_radiomics_tpu_torch.cli import train as cli_train
    from vit_deep_radiomics_tpu_torch.utils.config import save_yaml

    (tmp_path / ".git").mkdir()
    save_yaml(tiny_cfg(dim=DIM), tmp_path / "conf" / "parameters_models.yaml")
    os.symlink(store["root"] / "features", tmp_path / "features")
    monkeypatch.chdir(tmp_path)
    assert cli_merge.main(["--feature-dir", "features", "--datasets",
                           "stanford_dataset"]) == 0
    assert cli_split.main(["--feature-dir", "features",
                           "--n-splits", "2"]) == 0
    os.makedirs("data")
    os.symlink(tmp_path / "features", tmp_path / "data" / "features")
    args = ["-m", "petct", "-l", "crossmodal", "--folds", "0",
            "--precision", "parity", "--device", "cpu"]
    assert cli_train.main(args + ["--max-epochs", "1"]) == 0
    assert (tmp_path / "models" / "petct" / "medsam_transformer_stanford"
            / "petct" / "kfold_0" / "model_epoch_0000.pt").exists()
    out = tmp_path / "report.json"
    assert cli_eval.main(["-m", "petct", "-l", "crossmodal", "--fold", "0",
                          "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["epoch"] == 0

    # to-pth: the reference's names, which JAX's converter also reads
    from vit_deep_radiomics_tpu.models.convert import \
        transformer_classifier_params_from_torch
    from vit_deep_radiomics_tpu_torch.cli import convert as cli_convert

    ckpt = next((tmp_path / "models").rglob("model_epoch_0000.pt"))
    assert cli_convert.main(["to-pth", str(ckpt), "-o", "m.pth"]) == 0
    sd = torch.load("m.pth", weights_only=True)
    tt = _port("bimodal")
    tt.model.load_state_dict(sd, strict=True)
    transformer_classifier_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, bimodal=True)

    # the sweep's grid restricted to the conv classifier on this dataset
    from vit_deep_radiomics_tpu_torch.cli import sweep as cli_sweep

    assert cli_sweep.main(["--archs", "conv", "--datasets", "stanford",
                           "--max-epochs", "1", "--precision", "parity",
                           "--device", "cpu"]) == 0
    assert (tmp_path / "models" / "petct" / "medsam_conv_stanford" / "pet"
            / "kfold_1" / "losses.html").exists()


# whole volumes: CT 9 slices of 24 x 24 fully masked cells (576 tokens a
# slice), so a test item's 8 slices are 4608 tokens (bucket 8192, past
# DEFAULT_BUCKETS' 4096); one layer and one head a modality, batch 1
WV_LAYER = {"num_layers": 1, "num_heads": 1, "mlp_ratio": 2}


@pytest.fixture(scope="module")
def wv_store(tmp_path_factory):
    pytest.importorskip("h5py")
    pytest.importorskip("sklearn")
    root = tmp_path_factory.mktemp("wv_store")
    df, h5_ct, h5_pet = write_store(root, n_patients=4, dim=DIM,
                                    slices={"ct": 9, "pet": 3}, grid=24,
                                    full_masks=True)
    from vit_deep_radiomics_tpu_torch.data import splits

    cfg = tiny_cfg(splits.build_kfold_patients(df, n_splits=2), dim=DIM)
    cfg["models"]["transformer"].update(ct=WV_LAYER, pet=WV_LAYER)
    return {"df": df, "ct": h5_ct, "pet": h5_pet, "cfg": cfg}


def test_whole_volume_train_and_evaluate_match_jax(wv_store, tmp_path,
                                                   monkeypatch):
    """``train_kfold(whole_volume=True)`` of one fold in both packages
    (dropout 0, the same initial weights): the port's batches keep every
    token of the items (CT past 4096 in a bucket of 8192, mask sums equal
    to the item lengths, no truncation warning), the histories agree
    within 1e-5, and ``evaluate_checkpoint(whole_volume=True)`` of each
    package's checkpoint gives the same report."""
    import warnings

    cfg = wv_store["cfg"]
    kw = dict(arch="transformer", modality="petct", loss="crossmodal",
              batch_size=1, precision="parity", max_epochs=1,
              whole_volume=True)
    jt = jtrain.FoldTrainer(cfg, jtrain.TrainerConfig(**kw))
    jt.init_params(_batches(np.random.default_rng(0), 1, "bimodal")[0])
    state0 = classifier_params_from_jax(jax.device_get(jt.params))
    j_init, t_init = jtrain.FoldTrainer.init_params, \
        ttrain.FoldTrainer.init_params

    def jax_init(self, batch):
        self.model = self.model.clone(dropout_rate=0.0)
        j_init(self, batch)

    def port_init(self, state_dict=None):
        self.model.dropout_rate = 0.0
        t_init(self, state0 if state_dict is None else state_dict)

    seen = []
    real_batch_items = ttrain.batch_items

    def spy(items, bsz, **bkw):
        for i, b in enumerate(real_batch_items(items, bsz, **bkw)):
            seen.append(([it.tokens_ct.shape[0]
                          for it in items[i * bsz:(i + 1) * bsz]],
                         b["ct_mask"].sum(axis=1), b["ct"].shape[1]))
            yield b

    monkeypatch.setattr(jtrain.FoldTrainer, "init_params", jax_init)
    monkeypatch.setattr(ttrain.FoldTrainer, "init_params", port_init)
    monkeypatch.setattr(ttrain, "batch_items", spy)
    hist = {}
    for label, mod in (("jax", jtrain), ("port", ttrain)):
        tcfg = mod.TrainerConfig(**kw, **(
            {"device": "cpu"} if mod is ttrain else {}))
        with warnings.catch_warnings():
            # JAX's init batch (one item, default buckets) truncates with a
            # warning; every batch of the port's must not
            warnings.simplefilter("error" if mod is ttrain else "ignore",
                                  UserWarning)
            hist[label] = mod.train_kfold(
                wv_store["df"], cfg, tcfg, wv_store["ct"], wv_store["pet"],
                tmp_path / label, folds=[0], log=lambda *_: None)[0]
    lengths = [n for lens, _, _ in seen for n in lens]
    assert max(lengths) > 4096
    assert max(bucket for *_, bucket in seen) == 8192
    assert sorted(lengths) == sorted(int(m) for _, sums, _ in seen
                                     for m in sums)
    for col in ttrain.HISTORY_KEYS:
        np.testing.assert_allclose(
            np.asarray(hist["port"][col], np.float64),
            np.asarray(hist["jax"][col], np.float64), rtol=0,
            atol=LOSS_ATOL, err_msg=col)

    # the checkpoint of epoch 0 over the fold's test split is the
    # evaluation JAX's trainer reported after epoch 0
    from vit_deep_radiomics_tpu_torch.engine.evaluate import \
        evaluate_checkpoint

    df = wv_store["df"]
    df_test = df[df["patient_id"].isin(
        cfg["kfold_patients"]["ct"]["stanford"][0]["test"])]
    fold = ("petct", "medsam_transformer_stanford", "petct", "kfold_0")
    got = evaluate_checkpoint(
        df_test, cfg, ttrain.TrainerConfig(**kw, device="cpu"),
        wv_store["ct"], wv_store["pet"], tmp_path.joinpath("port", *fold), 0)
    ref = json.loads(tmp_path.joinpath("jax", *fold,
                                       "test_metrics_0.json").read_text())
    assert abs(got["loss"] - ref["loss"]) <= LOSS_ATOL
    got["loss"] = ref["loss"]
    _same_report(ref, json.loads(json.dumps(got)))


class TestRefusals:
    def test_default_device_raises_without_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = tiny_cfg(dim=DIM)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.FoldTrainer(cfg, ttrain.TrainerConfig())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trep.device_epoch_report([0, 1], [0.2, 0.7], None, kfold=0,
                                     loss=0.0, epoch=0, split="test")

    @pytest.mark.parametrize("what", ["mesh", "int8"])
    def test_multi_device_modes_raise(self, what):
        cfg = tiny_cfg(dim=DIM)
        kw = {"device": "cpu"}
        mesh = None
        if what == "mesh":
            mesh = object()
        else:
            kw["precision"] = "int8"
        err = ValueError if what == "int8" else NotImplementedError
        with pytest.raises(err):
            ttrain.FoldTrainer(cfg, ttrain.TrainerConfig(**kw), mesh)
        if what != "int8":
            with pytest.raises(NotImplementedError):
                ttrain.train_kfold(None, cfg, ttrain.TrainerConfig(**kw),
                                   None, None, None, mesh=mesh)

    @pytest.mark.parametrize("cli", ["train", "evaluate", "sweep"])
    def test_cli_parser_defaults(self, cli):
        """JAX's flags and defaults, and ``--device`` (the card)."""
        import importlib

        jcli = importlib.import_module(f"vit_deep_radiomics_tpu.cli.{cli}")
        tcli = importlib.import_module(
            f"vit_deep_radiomics_tpu_torch.cli.{cli}")
        ref = vars(jcli.build_parser().parse_args([]))
        got = vars(tcli.build_parser().parse_args([]))
        assert got.pop("device") == "cuda"
        assert got == ref


def test_training_modules_import_without_pandas():
    """The card's machine has no pandas, h5py, sklearn or yaml: the
    modules chip_smoke.py's phases 21 and 23 drive import without them."""
    import subprocess

    code = (
        "import sys\n"
        "for m in ('pandas', 'h5py', 'sklearn', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "from vit_deep_radiomics_tpu_torch.engine import train, checkpoint\n"
        "from vit_deep_radiomics_tpu_torch.engine import foldpar\n"
        "from vit_deep_radiomics_tpu_torch.analysis import reports\n"
        "from vit_deep_radiomics_tpu_torch.data import datasets\n"
        "assert train.FoldTrainer and train.FoldBookkeeping\n"
        "assert foldpar.ParallelFoldTrainer and foldpar.stack_fold_batches\n"
        "assert datasets.batch_items and reports.device_epoch_report\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]


def test_chip_smoke_config_is_the_published_one():
    """Phase 21 of chip_smoke.py carries the published classifier configs
    (the card's machine has no yaml): they equal conf/parameters_models.
    yaml's, and its buckets reach runtime.max_tokens."""
    pytest.importorskip("yaml")
    from vit_deep_radiomics_tpu_torch.utils.config import load_all_ymls

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke

    conf = load_all_ymls(os.path.join(root, "conf"))
    assert chip_smoke.CLASSIFIER_CFG["models"] == conf["models"]
    assert chip_smoke.MAX_TOKENS == conf["runtime"]["max_tokens"]
