"""The port's training data path against the JAX package's on a tiny
synthetic HDF5 + parquet store written here: windows, dataset items (with
and without augmentation, one seed), batches, splits, the merged metadata,
the config loader and the lr schedule.

Tolerances: token values 1e-6 (the positional encoding's sin/cos may
differ in the last bit); frames, masks, buckets, shapes, labels, patient
ids and item order exactly.
"""

import math

import numpy as np
import pytest

pytest.importorskip("h5py")
pd = pytest.importorskip("pandas")

from torch_train_store import tiny_cfg, write_store  # noqa: E402

from vit_deep_radiomics_tpu.data import datasets as jds  # noqa: E402
from vit_deep_radiomics_tpu.data import feature_store as jfs  # noqa: E402
from vit_deep_radiomics_tpu.data import splits as jsplits  # noqa: E402
from vit_deep_radiomics_tpu.engine import train as jtrain  # noqa: E402
from vit_deep_radiomics_tpu.utils import config as jconfig  # noqa: E402
from vit_deep_radiomics_tpu.utils import native as jnative  # noqa: E402
from vit_deep_radiomics_tpu_torch.data import datasets as tds  # noqa: E402
from vit_deep_radiomics_tpu_torch.data import feature_store as tfs  # noqa
from vit_deep_radiomics_tpu_torch.data import splits as tsplits  # noqa: E402
from vit_deep_radiomics_tpu_torch.engine import train as ttrain  # noqa: E402
from vit_deep_radiomics_tpu_torch.utils import config as tconfig  # noqa
from vit_deep_radiomics_tpu_torch.utils import native as tnative  # noqa

TOKEN_ATOL = 1e-6
DIM = 16


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_store")
    df, h5_ct, h5_pet = write_store(root, dim=DIM)
    return {"root": root, "df": df, "ct": h5_ct, "pet": h5_pet}


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """The store's metadata frame alone, written without the HDF5 stores:
    the splits read nothing else, so their test does not depend on HDF5
    writes (under xdist, extraction tests sharing a worker have failed
    in h5py with "no VOL object wrap context" and H5Dwrite_chunk
    errors)."""
    return write_store(tmp_path_factory.mktemp("torch_frame"), dim=DIM,
                       features=False)[0]


def test_merge_metadata_matches_jax(store):
    feat_dir = store["root"] / "features"
    ref = jfs.merge_metadata(feat_dir, datasets=("stanford_dataset",),
                             output_path=store["root"] / "jax.parquet")
    got = tfs.merge_metadata(feat_dir, datasets=("stanford_dataset",),
                             output_path=store["root"] / "port.parquet")
    pd.testing.assert_frame_equal(got, ref)
    with pytest.raises(FileNotFoundError):
        tfs.merge_metadata(store["root"], datasets=("none",))


@pytest.mark.parametrize("modality_b", ["ct", "chest"])
def test_prepare_windows_matches_jax(store, modality_b):
    df = store["df"].copy()
    if modality_b == "chest":
        df.loc[df["modality"] == "ct", "modality"] = "chest"
    ref = jds.prepare_windows(df, "pet", modality_b)
    got = tds.prepare_windows(df, "pet", modality_b)
    pd.testing.assert_frame_equal(got, ref)
    ct = got[got["modality"] == modality_b]
    # 16 slices, window 13: starts 0, 1, 2
    assert ct.groupby("patient_id")["patient_id_new"].nunique().eq(3).all()


def _items(mod, df, store, aug, arch, seed):
    ds = mod.PETCTDataset(df, store["ct"], store["pet"],
                          use_augmentation=aug, feature_dim=DIM, arch=arch,
                          seed=seed)
    # two passes: the second continues the Generator's stream
    return [ds[i] for _ in range(2) for i in range(len(ds))]


def _same_items(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.patient_id == b.patient_id
        np.testing.assert_array_equal(a.label_onehot, b.label_onehot)
        for x, y in ((a.tokens_ct, b.tokens_ct), (a.tokens_pet, b.tokens_pet)):
            assert x.shape == y.shape and y.dtype == np.float32
            np.testing.assert_allclose(y, x, rtol=0, atol=TOKEN_ATOL)


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("aug", [False, True], ids=["plain", "augmented"])
@pytest.mark.parametrize("arch", ["transformer", "conv"])
def test_dataset_items_match_jax(store, monkeypatch, arch, aug, packer):
    """One seed, the same items: the augmentation draws, windows, PET
    ranges, tokens (or conv volumes), labels and order; through the native
    packer when its library loads, and through each package's numpy
    path."""
    if packer == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not (jnative.available() and tnative.available()):
        pytest.skip("the native token packer does not build here")
    df = jds.prepare_windows(store["df"])
    ref = _items(jds, df, store, aug, arch, seed=5)
    got = _items(tds, df, store, aug, arch, seed=5)
    _same_items(ref, got)
    assert all(it.tokens_ct.ndim == (4 if arch == "conv" else 2)
               for it in got)


def _random_items(rng, n, conv=False):
    items = []
    for i in range(n):
        if conv:
            ct = rng.normal(size=(rng.integers(1, 6), rng.integers(3, 12),
                                  rng.integers(3, 12), DIM))
            pet = rng.normal(size=(rng.integers(1, 3), 4, 5, DIM))
        else:
            ct = rng.normal(size=(rng.integers(1, 700), DIM))
            pet = rng.normal(size=(rng.integers(1, 300), DIM))
        label = np.eye(2, dtype=np.float32)[i % 2]
        items.append(jds.TokenItem(ct.astype(np.float32),
                                   pet.astype(np.float32), label, f"p{i}"))
    return items


def _same_batches(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "patient_ids":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["tokens", "fixed", "conv"])
def test_batch_items_match_jax(kind):
    rng = np.random.default_rng(4)
    items = _random_items(rng, 11, conv=kind == "conv")
    titems = [tds.TokenItem(it.tokens_ct, it.tokens_pet, it.label_onehot,
                            it.patient_id) for it in items]
    kw = {"fixed_buckets": (1024, 512)} if kind == "fixed" else {}
    ref = list(jds.batch_items(items, 3, **kw))
    got = list(tds.batch_items(titems, 3, **kw))
    _same_batches(ref, got)
    if kind == "tokens":
        # the trainer's bucket order
        assert [it.patient_id for it in ttrain._bucket_sorted(titems)] == \
            [it.patient_id for it in jtrain._bucket_sorted(items)]


def test_token_buckets_and_truncation():
    rng = np.random.default_rng(0)
    big = tds.TokenItem(rng.normal(size=(5000, 8)).astype(np.float32),
                        rng.normal(size=(600, 8)).astype(np.float32),
                        np.array([1.0, 0.0], np.float32), "p0")
    assert tds.token_buckets_for([big]) == jds.token_buckets_for([big])
    t = rng.normal(size=(300, 8)).astype(np.float32)
    with pytest.warns(UserWarning, match="truncating"):
        padded, mask = tds.pad_tokens(t, (64, 128, 256))
    assert padded.shape == (256, 8) and mask.all()
    assert [tds.find_divisor(n, m) for n, m in
            ((40, "ct"), (40, "chest"), (40, "pet"), (5, "ct"), (0, "pet"))
            ] == [jds.find_divisor(n, m) for n, m in
                  ((40, "ct"), (40, "chest"), (40, "pet"), (5, "ct"),
                   (0, "pet"))]
    img = np.arange(35, dtype=np.float32).reshape(5, 7)
    np.testing.assert_array_equal(tds.nearest_resize(img, (3, 4)),
                                  jds.nearest_resize(img, (3, 4)))


@pytest.mark.parametrize("n_splits", [2, 3])
def test_kfold_patients_and_yaml_match_jax(frame, tmp_path, n_splits):
    pytest.importorskip("sklearn")
    pytest.importorskip("yaml")
    ref = jsplits.build_kfold_patients(frame, n_splits=n_splits)
    got = tsplits.build_kfold_patients(frame, n_splits=n_splits)
    assert got == ref
    (tmp_path / ".git").mkdir()
    conf = tmp_path / "conf"
    tsplits.write_kfold_yaml(got, conf)
    tconfig.save_yaml(tiny_cfg(), conf / "parameters_models.yaml")
    assert tconfig.load_conf(root=tmp_path) == jconfig.load_conf(
        root=tmp_path)
    assert tconfig.load_conf(root=tmp_path)["kfold_patients"] == ref


def test_config_merge_matches_jax():
    a = {"models": {"x": {"a": 1, "b": {"c": 2}}}, "k": 1}
    b = {"models": {"x": {"b": {"d": 3}}, "y": 2}, "k": 5}
    assert tconfig.deep_merge(a, b) == jconfig.deep_merge(a, b)


def test_cosine_lr_matches_jax():
    for epochs in (2, 10, 50):
        for epoch in range(2 * epochs):
            assert ttrain.cosine_lr(epoch, 5e-4, epochs) == \
                jtrain.cosine_lr(epoch, 5e-4, epochs)
    assert math.isclose(ttrain.cosine_lr(0, 5e-4, 50), 5e-4)


def test_merge_part_stores(tmp_path):
    """Part stores of disjoint patients fold into the contract file."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    for part, pid in enumerate(("a", "b")):
        tfs.save_features(tmp_path / f"features_masks_ct.part{part}.hdf5",
                          [rng.normal(size=(2, 2, 4)).astype(np.float32)],
                          [np.ones((4, 4), np.float32)], pid)
    merged = tfs.merge_part_stores(tmp_path, modalities=("ct", "pet"))
    assert merged == [str(tmp_path / "features_masks_ct.hdf5")]
    with h5py.File(merged[0], "r") as f:
        assert sorted(f) == ["a", "b"]
    assert not list(tmp_path.glob("*.part*.hdf5"))
