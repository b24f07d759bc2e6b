"""Port vs JAX: the extraction engine, with shared weights.

Both packages build the small extractor of tests/test_sampling_extract.py
(SAM-shaped, width 96, 3 heads, fp32 ``parity``, plain attention); the
port gets the JAX weights through params_from_jax. Features agree to fp32
tolerance; masks, metadata, crop buckets and parquet frames are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from vit_deep_radiomics_tpu.data import feature_store as j_store
from vit_deep_radiomics_tpu.data import synthetic as j_syn
from vit_deep_radiomics_tpu.engine import extract as jex
from vit_deep_radiomics_tpu.models.vit import SAM_VIT_B as J_SAM
from vit_deep_radiomics_tpu_torch.data import feature_store as t_store
from vit_deep_radiomics_tpu_torch.data import synthetic as t_syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models.convert import params_from_jax
from vit_deep_radiomics_tpu_torch.models.vit import SAM_VIT_B as T_SAM

SMALL = dict(image_size=64, width=96, depth=2, num_heads=3, window_size=2,
             global_indexes=(1,), neck_channels=32)
RUN = dict(model_name="medsam", image_size=64, slice_batch=4,
           precision="parity", use_flash=False,
           flips=(None, "horizontal"), angles=(0, 90))
FEAT_TOL = 2e-5
# bf16 policies against JAX's extractor under the same policy and weights:
# about 1.5 times the measured max gap (inference 0.031, int8 0.055 on
# features of max |x| 2.6)
BF16_FEAT_TOL = {"inference": 5e-2, "int8": 8.5e-2}


def _pair(angles=(0, 90)):
    """(JAX extractor, port extractor) with the same weights."""
    j = jex.DenseExtractor(
        jex.ExtractionConfig(volume_bucket=32, **dict(RUN, angles=angles)),
        backbone_cfg=dataclasses.replace(J_SAM, **SMALL))
    t_cfg = dataclasses.replace(T_SAM, **SMALL)
    t = tex.DenseExtractor(
        tex.ExtractionConfig(**dict(RUN, angles=angles)),
        state_dict=params_from_jax(
            jax.tree_util.tree_map(np.asarray, j.params), t_cfg),
        backbone_cfg=t_cfg, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def extractors():
    return _pair()


def _assert_same(got, want):
    (tf, tm, tmeta), (jf, jm, jmeta) = got, want
    assert tmeta == jmeta
    assert len(tf) == len(jf) == len(tm) == len(jm)
    for a, b in zip(tf, jf):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=FEAT_TOL, rtol=FEAT_TOL)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)


class TestExtractVolume:
    @pytest.mark.parametrize("modality,seed", [("ct", 0), ("pet", 1),
                                               ("ct", 2)])
    def test_matches_jax(self, extractors, modality, seed):
        rng = np.random.default_rng(seed)
        vol, mask, _ = t_syn.synthetic_volume(rng, 64, 64, 3,
                                              modality=modality)
        j, t = extractors
        _assert_same(t.extract_volume(vol, mask, modality),
                     j.extract_volume(vol, mask, modality))

    def test_all_four_angles_border_nodule(self):
        """45/135 degree rotations and a nodule at the image corner (the
        one-sided crop clamp)."""
        j, t = _pair(angles=(0, 45, 90, 135))
        rng = np.random.default_rng(3)
        vol = rng.normal(-700, 100, size=(64, 64, 2)).astype(np.float32)
        mask = np.zeros((64, 64, 2), bool)
        mask[0:9, 55:64, :] = True
        vol[mask] = 35.0
        _assert_same(t.extract_volume(vol, mask, "ct"),
                     j.extract_volume(vol, mask, "ct"))

    def test_aug_groups_match_one_group(self, extractors):
        """One augmentation per resample group (the path a large volume
        takes at 1024²) gives what one group of all of them gives."""
        t = extractors[1]
        rng = np.random.default_rng(7)
        vol, mask, _ = t_syn.synthetic_volume(rng, 64, 64, 3)
        one = t.extract_volume(vol, mask, "ct")
        t.config.aug_group = 1
        try:
            grouped = t.extract_volume(vol, mask, "ct")
        finally:
            t.config.aug_group = None
        assert grouped[2] == one[2]
        for a, b in zip(grouped[0] + grouped[1], one[0] + one[1]):
            np.testing.assert_array_equal(a, b)

    def test_model_path_loads_a_sam_checkpoint(self, extractors, tmp_path):
        """``model_path`` reads a SAM/MedSAM ``.pth`` whose image-encoder
        weights carry the ``image_encoder.`` prefix of the reference
        checkpoint."""
        t = extractors[1]
        sd = {f"image_encoder.{k}": v.clone()
              for k, v in t.model.state_dict().items()}
        sd["mask_decoder.dummy"] = torch.zeros(1)
        torch.save(sd, tmp_path / "medsam.pth")
        loaded = tex.DenseExtractor(
            tex.ExtractionConfig(**dict(RUN, model_path=str(
                tmp_path / "medsam.pth"))),
            backbone_cfg=t.backbone_cfg, rng_seed=1, device="cpu")
        for k, v in t.model.state_dict().items():
            torch.testing.assert_close(loaded.model.state_dict()[k], v,
                                       rtol=0, atol=0)

    def test_empty_mask_raises(self, extractors):
        vol = np.zeros((64, 64, 2), np.float32)
        with pytest.raises(ValueError, match="empty"):
            extractors[1].extract_volume(vol, np.zeros_like(vol), "ct")

    @pytest.mark.parametrize("precision", ["inference", "int8"])
    def test_bf16_policies_match_jax(self, precision):
        """``inference`` and ``int8`` (K8's plain version on the CPU): the
        port's extractor holds bf16 parameters after load, and its
        features follow the JAX extractor's under the same policy and the
        same (bf16) weights; masks and metadata are equal."""
        run = dict(RUN, precision=precision)
        j = jex.DenseExtractor(
            jex.ExtractionConfig(volume_bucket=32, **run),
            backbone_cfg=dataclasses.replace(J_SAM, **SMALL))
        t_cfg = dataclasses.replace(T_SAM, **SMALL)
        t = tex.DenseExtractor(
            tex.ExtractionConfig(**run),
            state_dict=params_from_jax(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), j.params), t_cfg),
            backbone_cfg=t_cfg, device="cpu")
        assert {p.dtype for p in t.model.parameters()} == {torch.bfloat16}
        rng = np.random.default_rng(8)
        vol, mask, _ = t_syn.synthetic_volume(rng, 64, 64, 2)
        (tf, tm, tmeta), (jf, jm, jmeta) = (t.extract_volume(vol, mask, "ct"),
                                            j.extract_volume(vol, mask, "ct"))
        assert tmeta == jmeta and len(tf) == len(jf)
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a, b)
        gap = max(float(np.abs(a - b).max()) for a, b in zip(tf, jf))
        assert gap <= BF16_FEAT_TOL[precision], gap

    def test_fused_kernel_path_matches_jax_oracle(self):
        """A kernel-compatible head layout (2 heads of 64): the port's
        fused path (plain K1 on the CPU) against the JAX oracle."""
        small = dict(SMALL, width=128, num_heads=2)
        j = jex.DenseExtractor(
            jex.ExtractionConfig(volume_bucket=32, **RUN),
            backbone_cfg=dataclasses.replace(J_SAM, **small))
        t_cfg = dataclasses.replace(T_SAM, **small)
        t = tex.DenseExtractor(
            tex.ExtractionConfig(**dict(RUN, use_flash=True)),
            state_dict=params_from_jax(
                jax.tree_util.tree_map(np.asarray, j.params), t_cfg),
            backbone_cfg=t_cfg, device="cpu")
        rng = np.random.default_rng(4)
        vol, mask, _ = t_syn.synthetic_volume(rng, 64, 64, 3)
        _assert_same(t.extract_volume(vol, mask, "ct"),
                     j.extract_volume(vol, mask, "ct"))


class TestSweepCropBuckets:
    def test_equal_to_jax(self):
        rng = np.random.default_rng(5)
        unions = []
        for h, w in ((64, 64), (96, 80), (48, 64)):
            u = np.zeros((h, w), bool)
            y0, x0 = rng.integers(0, h - 10), rng.integers(0, w - 10)
            u[y0:y0 + rng.integers(2, 10), x0:x0 + rng.integers(2, 10)] = 1
            unions.append((h, w, u))
        corner = np.zeros((64, 64), bool)
        corner[0:9, 55:64] = True
        unions.append((64, 64, corner))
        for angles in ((0, 90), (0, 45, 90, 135), (30,)):
            for grid in (4, 8, 64):
                assert tex.sweep_crop_buckets(unions, angles, grid) == \
                    jex.sweep_crop_buckets(unions, angles, grid)


class TestIsotropicSweep:
    def test_store_equals_jax_single_device_sweep(self, extractors,
                                                  tmp_path):
        import pandas as pd

        cohort = t_syn.synthetic_cohort(n_patients=2, seed=3, height=64,
                                        width=64, ct_slices=3, pet_slices=2)
        j_cohort = j_syn.synthetic_cohort(n_patients=2, seed=3, height=64,
                                          width=64, ct_slices=3,
                                          pet_slices=2)
        for pid in cohort:   # the port's generator is a faithful copy
            for mod in ("ct", "pet"):
                for a, b in zip(cohort[pid][mod], j_cohort[pid][mod]):
                    np.testing.assert_array_equal(a, b)
        h5, csv = tmp_path / "iso.hdf5", tmp_path / "iso.csv"
        t_syn.write_isotropic_hdf5(cohort, h5, csv)
        j, t = extractors
        kw = dict(modalities=("pet", "ct"), datasets=("stanford",))
        w_jax = jex.extract_isotropic_dataset(
            h5, csv, tmp_path / "jax", j, **kw)
        w_port = tex.extract_isotropic_dataset(h5, csv, tmp_path / "port",
                                               t, **kw)
        assert len(w_jax) == len(w_port) == 4
        for p_jax in w_jax:
            p_port = p_jax.replace(str(tmp_path / "jax"),
                                   str(tmp_path / "port"))
            pd.testing.assert_frame_equal(pd.read_parquet(p_port),
                                          pd.read_parquet(p_jax))
        for mod in ("ct", "pet"):
            s_jax = tmp_path / "jax" / f"features_masks_{mod}.hdf5"
            s_port = tmp_path / "port" / f"features_masks_{mod}.hdf5"
            pids = t_store.patient_ids_in_store(s_port)
            assert sorted(pids) == sorted(j_store.patient_ids_in_store(s_jax))
            for pid in pids:
                tf, tm = t_store.read_patient_features(s_port, pid)
                jf, jm = j_store.read_patient_features(s_jax, pid)
                assert len(tf) == len(jf)
                for a, b in zip(tf, jf):
                    np.testing.assert_allclose(a, b, atol=FEAT_TOL,
                                               rtol=FEAT_TOL)
                for a, b in zip(tm, jm):
                    np.testing.assert_array_equal(a, b)
        # resume: a second run writes nothing
        assert tex.extract_isotropic_dataset(h5, csv, tmp_path / "port", t,
                                             **kw) == []

    def test_failure_recorded_against_its_patient(self, extractors,
                                                  tmp_path):
        """An empty CT mask fails only that item; the queue records it."""
        import h5py

        from vit_deep_radiomics_tpu_torch.engine.workqueue import WorkQueue

        cohort = t_syn.synthetic_cohort(n_patients=2, seed=11, height=64,
                                        width=64, ct_slices=3, pet_slices=2)
        h5, csv = tmp_path / "iso.hdf5", tmp_path / "iso.csv"
        t_syn.write_isotropic_hdf5(cohort, h5, csv)
        bad = "stanford_001"
        with h5py.File(h5, "r+") as f:
            grp = f[f"{bad}_ct/mask_exam"]
            for k in grp:
                data = grp[k][()]
                del grp[k]
                grp.create_dataset(k, data=np.zeros_like(data))
        feat_dir = tmp_path / "features"
        written = tex.extract_isotropic_dataset(
            h5, csv, feat_dir, extractors[1], modalities=("pet", "ct"),
            datasets=("stanford",), progress=lambda *_: None)
        assert len(written) == 3
        q = WorkQueue(feat_dir / "extract_queue.json")
        assert list(q.failed) == [f"stanford/{bad}/ct"]
        assert "empty nodule mask" in q.failed[f"stanford/{bad}/ct"]["error"]


class TestNotPortedYet:
    @pytest.mark.parametrize("over,match", [
        (dict(pipeline=True), "pipeline"),
        (dict(wire_dtype="int16"), "int16"),
        (dict(model_name="dinov2_vitb14"), "DINOv2"),
    ])
    def test_raises(self, over, match):
        with pytest.raises(NotImplementedError, match=match):
            tex.DenseExtractor(tex.ExtractionConfig(**over), device="cpu")

    def test_mesh_raises(self):
        with pytest.raises(NotImplementedError, match="mesh"):
            tex.DenseExtractor(device="cpu", mesh=object())

    def test_stage_times_attribute_the_volume(self, extractors):
        t = extractors[1]
        t.stats = tex.StageTimes()
        try:
            rng = np.random.default_rng(6)
            vol, mask, _ = t_syn.synthetic_volume(rng, 64, 64, 2)
            t.extract_volume(vol, mask, "ct")
            assert {"feed", "dispatch", "collect"} <= set(t.stats)
            assert all(v >= 0 for v in t.stats.values())
        finally:
            t.stats = None

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tex.DenseExtractor(tex.ExtractionConfig(image_size=64),
                               backbone_cfg=dataclasses.replace(
                                   T_SAM, **SMALL))
