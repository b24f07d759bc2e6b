"""Port vs JAX: DINOv2 dense extraction, the int16 CT wire, the DINOv2
checkpoint loader and the tfds source.

Both packages build their extractors through model names (``dinov2_vits14``:
full width 384, 12 layers, 6 heads of 64) at a tiny image size, in both
``dinov2_mode``s: ``patch_embed`` (the patch embedding alone) and ``full``
(the whole transformer). JAX initialises LayerScale to 1e-5, which would
leave the blocks out of any comparison, so the shared tree gets random
gammas and CLS token before the port takes it through
``dinov2_params_from_jax``. Features agree to fp32 2e-5 under ``parity``
(the measured gap is at most 5.0e-6); masks, metadata, crop buckets and parquet
frames are equal. Under ``fast`` the port's features are held to JAX's
``fast`` ones by the rule of ``tests/test_torch_extract.py``'s
``BF16_FEAT_TOL``: about 1.5 times the measured max gap.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.cli import extract as j_cli
from vit_deep_radiomics_tpu.data import feature_store as j_store
from vit_deep_radiomics_tpu.data import ingest as j_ingest
from vit_deep_radiomics_tpu.engine import extract as jex
from vit_deep_radiomics_tpu.models import convert as j_convert
from vit_deep_radiomics_tpu.models import vit as jvit
from vit_deep_radiomics_tpu.core.precision import PARITY as J_PARITY
from vit_deep_radiomics_tpu_torch.cli import extract as t_cli
from vit_deep_radiomics_tpu_torch.data import feature_store as t_store
from vit_deep_radiomics_tpu_torch.data import ingest as t_ingest
from vit_deep_radiomics_tpu_torch.data import synthetic as t_syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.models.convert import (
    dinov2_params_from_jax,
    load_dinov2_state_dict,
)

RUN = dict(model_name="dinov2_vits14", slice_batch=4, precision="parity",
           use_flash=False, flips=(None, "horizontal"), angles=(0, 90))
SIZE = {"full": 42, "patch_embed": 56}     # grids of 3 and 4 patches
FEAT_TOL = 2e-5
# `fast` (bf16) against JAX `fast` on the same weights, the whole
# transformer: about 1.5 times the measured max gap (0.047-0.055 over three
# volumes, on features of max |x| 3.4-3.8: one or two bf16 steps; JAX
# `fast` itself sits 0.054-0.071 from its fp32 oracle on them)
FAST_FEAT_TOL = 8.5e-2
# `int8` against JAX `int8`: JAX's own criterion for its int8 path, the
# smallest per-position cosine (JAX tests/test_quant.py:116)
INT8_MIN_COSINE = 0.995


def _random_layerscale(params, seed=0):
    """The JAX tree with LayerScale gammas about 0.1 and a random CLS token
    (JAX initialises them to 1e-5 and 0)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.array, params)
    p = params["params"]
    if "cls_token" in p:
        i = 0
        while f"block_{i}" in p:
            for name in ("ls1", "ls2"):
                p[f"block_{i}"][name] = (0.1 + 0.05 * rng.normal(
                    size=p[f"block_{i}"][name].shape)).astype(np.float32)
            i += 1
        p["cls_token"] = (0.1 * rng.normal(
            size=p["cls_token"].shape)).astype(np.float32)
    return params


def _pair(mode, image_size=None, port_flash=False, **over):
    """(JAX extractor, port extractor) of ``dinov2_vits14`` with the same
    weights, built through the model name."""
    run = dict(RUN, dinov2_mode=mode,
               image_size=SIZE[mode] if image_size is None else image_size,
               **over)
    j = jex.DenseExtractor(jex.ExtractionConfig(volume_bucket=32, **run))
    j.params = _random_layerscale(j.params)
    t_run = dict(run, use_flash=port_flash or run["use_flash"])
    t_cfg = tex.ExtractionConfig(**t_run)
    sd = dinov2_params_from_jax(j.params, tex._backbone_for(t_cfg)[0])
    return j, tex.DenseExtractor(t_cfg, state_dict=sd, device="cpu")


@pytest.fixture(scope="module")
def full_pair():
    return _pair("full")


@pytest.fixture(scope="module")
def patch_pair():
    return _pair("patch_embed")


def _assert_same(got, want, tol=FEAT_TOL):
    (tf, tm, tmeta), (jf, jm, jmeta) = got, want
    assert tmeta == jmeta
    assert len(tf) == len(jf) == len(tm) == len(jm)
    for a, b in zip(tf, jf):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)


def _volume(seed, modality="ct", h=64, w=64, s=3):
    return t_syn.synthetic_volume(np.random.default_rng(seed), h, w, s,
                                  modality=modality)[:2]


class TestExtractVolume:
    @pytest.mark.parametrize("mode", ["full", "patch_embed"])
    @pytest.mark.parametrize("modality,seed", [("ct", 0), ("pet", 1)])
    def test_parity_matches_jax(self, full_pair, patch_pair, mode, modality,
                                seed):
        """CT through HU→RGB / 255 and PET through /max, features in the
        policy's output dtype, crops from the backbone's own grid."""
        j, t = full_pair if mode == "full" else patch_pair
        assert t.model.patch_embed_only == (mode == "patch_embed")
        vol, mask = _volume(seed, modality)
        _assert_same(t.extract_volume(vol, mask, modality),
                     j.extract_volume(vol, mask, modality))

    def test_fused_kernel_path_matches_jax_oracle(self, full_pair):
        """The port's kernel path (K2 in kv_len mode, its plain version on
        the CPU, over the tokens padded as JAX pads them) against the JAX
        oracle on the same weights."""
        j, _ = full_pair
        t_cfg = tex.ExtractionConfig(**dict(RUN, dinov2_mode="full",
                                            image_size=SIZE["full"],
                                            use_flash=True))
        t = tex.DenseExtractor(t_cfg, state_dict=dinov2_params_from_jax(
            j.params, tex._backbone_for(t_cfg)[0]), device="cpu")
        vol, mask = _volume(2)
        _assert_same(t.extract_volume(vol, mask, "ct"),
                     j.extract_volume(vol, mask, "ct"))

    def test_fast_matches_jax_fast(self):
        """``fast`` (bf16), the whole transformer through the fused paths
        of both packages (the port's plain K2, JAX's Pallas kernels in
        interpret mode): masks and metadata equal, features within
        FAST_FEAT_TOL."""
        j, t = _pair("full", precision="fast", use_flash=True)
        vol, mask = _volume(3)
        (tf, tm, tmeta), (jf, jm, jmeta) = (t.extract_volume(vol, mask, "ct"),
                                            j.extract_volume(vol, mask, "ct"))
        assert tmeta == jmeta and len(tf) == len(jf)
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a, b)
        gap = max(float(np.abs(a - b).max()) for a, b in zip(tf, jf))
        assert gap <= FAST_FEAT_TOL, gap

    @pytest.mark.parametrize("precision", ["inference", "int8"])
    def test_bf16_policies_match_jax(self, precision):
        """``inference`` and ``int8`` (K8's plain version on the CPU, JAX's
        Pallas kernel in interpret mode), the whole transformer through the
        fused paths of both packages on the same bridged weights: masks and
        metadata equal, ``inference`` features within FAST_FEAT_TOL (one
        or two bf16 steps, as ``fast``), ``int8``'s by JAX's criterion, the
        smallest per-position cosine above INT8_MIN_COSINE."""
        j, t = _pair("full", precision=precision, use_flash=True)
        assert {p.dtype for p in t.model.parameters()} == {torch.bfloat16}
        vol, mask = _volume(5)
        (tf, tm, tmeta), (jf, jm, jmeta) = (t.extract_volume(vol, mask, "ct"),
                                            j.extract_volume(vol, mask, "ct"))
        assert tmeta == jmeta and len(tf) == len(jf)
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a, b)
        gap = max(float(np.abs(a - b).max()) for a, b in zip(tf, jf))
        a = np.concatenate([f.reshape(-1, f.shape[-1]) for f in tf])
        b = np.concatenate([f.reshape(-1, f.shape[-1]) for f in jf])
        a, b = a.astype(np.float64), b.astype(np.float64)
        cos = float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                        * np.linalg.norm(b, axis=-1))).min())
        print(f"{precision}: max abs gap {gap:.3e}, smallest cosine "
              f"{cos:.6f}")
        if precision == "inference":
            assert gap <= FAST_FEAT_TOL, gap
        else:
            assert cos > INT8_MIN_COSINE, cos

    def test_patch_embed_at_its_default_size(self):
        """The reference's mode at its own size, 896 px: a 64 x 64 grid of
        width 384, features equal to JAX's."""
        j, t = _pair("patch_embed", image_size=0, flips=(None,),
                     angles=(0,))              # 0: the mode's default
        assert t.image_size == 896 and t.backbone_cfg.grid == 64
        with torch.no_grad():
            assert t.model(torch.zeros(1, 896, 896, 3)).shape == \
                (1, 64, 64, 384)
        vol, mask = _volume(4, s=1)
        _assert_same(t.extract_volume(vol, mask, "ct"),
                     j.extract_volume(vol, mask, "ct"))


class TestConfig:
    @pytest.mark.parametrize("name", sorted(tvit.DINOV2_CONFIGS))
    @pytest.mark.parametrize("mode", ["full", "patch_embed"])
    @pytest.mark.parametrize("image_size", [None, 224])
    def test_backbone_for_equals_jax(self, name, mode, image_size):
        """Image size (896 in patch_embed mode, 518 in full mode by
        default), grid, width and patch_embed_only as JAX chooses them."""
        kw = dict(model_name=name, dinov2_mode=mode, image_size=image_size)
        t_cfg, t_only = tex._backbone_for(tex.ExtractionConfig(**kw))
        j_cfg, j_only = jex._backbone_for(jex.ExtractionConfig(**kw))
        assert t_only == j_only == (mode == "patch_embed")
        for field in ("image_size", "grid", "width", "depth", "num_heads",
                      "patch_size"):
            assert getattr(t_cfg, field) == getattr(j_cfg, field), field

    def test_int8_patch_embed_refused_as_jax(self):
        cfg = dict(model_name="dinov2_vits14", dinov2_mode="patch_embed",
                   precision="int8", image_size=28)
        with pytest.raises(ValueError) as j_err:
            jex.DenseExtractor(jex.ExtractionConfig(**cfg))
        with pytest.raises(ValueError) as t_err:
            tex.DenseExtractor(tex.ExtractionConfig(**cfg), device="cpu")
        assert str(t_err.value) == str(j_err.value)

    def test_backbone_cfg_runs_the_whole_transformer(self):
        """An explicit backbone config means the full model in both
        packages, whatever ``dinov2_mode`` says (JAX :328-332)."""
        cfg = dataclasses.replace(tvit.DINOV2_CONFIGS["dinov2_vits14"],
                                  image_size=28, depth=1)
        t = tex.DenseExtractor(tex.ExtractionConfig(**dict(
            RUN, dinov2_mode="patch_embed")), backbone_cfg=cfg,
            device="cpu")
        assert not t.model.patch_embed_only and len(t.model.blocks) == 1


class TestInt16Wire:
    @pytest.mark.parametrize("mode", ["full", "patch_embed"])
    def test_matches_jax_int16_wire(self, full_pair, patch_pair, mode):
        """Fractional HU: the port's int16 wire gives JAX's int16 wire's
        features; they are exactly the float32 wire's on the rounded
        volume, and not the float32 wire's on the fractional one."""
        j, t = full_pair if mode == "full" else patch_pair
        vol, mask = _volume(5)
        vol = vol + np.random.default_rng(6).uniform(
            -0.5, 0.5, vol.shape).astype(np.float32)
        j.config.wire_dtype = t.config.wire_dtype = "int16"
        try:
            got = t.extract_volume(vol, mask, "ct")
            _assert_same(got, j.extract_volume(vol, mask, "ct"))
        finally:
            j.config.wire_dtype = t.config.wire_dtype = "float32"
        rounded = t.extract_volume(np.rint(vol), mask, "ct")
        fractional = t.extract_volume(vol, mask, "ct")
        for a, b in zip(got[0], rounded[0]):
            np.testing.assert_array_equal(a, b)
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(got[0], fractional[0])) > 0

    def test_sam_window_matches_jax(self):
        """The MedSAM window takes the wire too (a small SAM-shaped
        backbone on both sides)."""
        from vit_deep_radiomics_tpu.models.vit import SAM_VIT_B as J_SAM
        from vit_deep_radiomics_tpu_torch.models.convert import (
            params_from_jax,
        )

        small = dict(image_size=64, width=96, depth=2, num_heads=3,
                     window_size=2, global_indexes=(1,), neck_channels=32)
        run = dict(RUN, model_name="medsam", image_size=64,
                   wire_dtype="int16")
        j = jex.DenseExtractor(jex.ExtractionConfig(volume_bucket=32, **run),
                               backbone_cfg=dataclasses.replace(J_SAM,
                                                                **small))
        t_cfg = dataclasses.replace(tvit.SAM_VIT_B, **small)
        t = tex.DenseExtractor(
            tex.ExtractionConfig(**run), backbone_cfg=t_cfg, device="cpu",
            state_dict=params_from_jax(jax.tree_util.tree_map(
                np.asarray, j.params), t_cfg))
        vol, mask = _volume(7)
        vol = vol + 0.37
        _assert_same(t.extract_volume(vol, mask, "ct"),
                     j.extract_volume(vol, mask, "ct"))

    def test_unknown_wire_refused(self):
        with pytest.raises(ValueError, match="wire_dtype"):
            tex.DenseExtractor(tex.ExtractionConfig(wire_dtype="int8"),
                               device="cpu")


def _sweep_inputs(tmp_path, seed=3):
    cohort = t_syn.synthetic_cohort(n_patients=2, seed=seed, height=48,
                                    width=48, ct_slices=2, pet_slices=2)
    h5, csv = tmp_path / "iso.hdf5", tmp_path / "iso.csv"
    t_syn.write_isotropic_hdf5(cohort, h5, csv)
    return h5, csv


def _assert_same_stores(jax_dir, port_dir, w_jax, w_port):
    import pandas as pd

    assert len(w_jax) == len(w_port) > 0
    for p_jax in w_jax:
        p_port = p_jax.replace(str(jax_dir), str(port_dir))
        pd.testing.assert_frame_equal(pd.read_parquet(p_port),
                                      pd.read_parquet(p_jax))
    for mod in ("ct", "pet"):
        s_jax = jax_dir / f"features_masks_{mod}.hdf5"
        s_port = port_dir / f"features_masks_{mod}.hdf5"
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


class TestSweeps:
    def test_isotropic_full_mode_equals_jax_sweep(self, full_pair,
                                                  tmp_path):
        """``extract_isotropic_dataset`` in ``full`` mode: the store and
        the parquets equal the JAX single-device sweep's (crop buckets
        from the backbone's 3 x 3 grid)."""
        h5, csv = _sweep_inputs(tmp_path)
        j, t = full_pair
        kw = dict(modalities=("pet", "ct"), datasets=("stanford",))
        w_jax = jex.extract_isotropic_dataset(h5, csv, tmp_path / "jax", j,
                                              **kw)
        w_port = tex.extract_isotropic_dataset(h5, csv, tmp_path / "port",
                                               t, **kw)
        _assert_same_stores(tmp_path / "jax", tmp_path / "port", w_jax,
                            w_port)

    def test_samples_to_voxels_equals_jax(self):
        for pet in (False, True):
            stream = _stream(np.random.default_rng(8), "pet" if pet else "ct",
                             1)
            got = t_ingest.samples_to_voxels(stream, pet=pet)
            want = j_ingest.samples_to_voxels(stream, pet=pet)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="no slices"):
            t_ingest.samples_to_voxels([])

    def test_tfds_sweep_equals_jax(self, full_pair, tmp_path):
        """``extract_tfds_dataset`` through a duck-typed loader: the label
        filter (a patient with label 2 skipped), PET liver normalisation,
        and stores and parquets equal to JAX's."""
        ds_pet, ds_ct, pids = _tfds_source()

        def loader(name, data_dir):
            assert name == "stanford_dataset"
            return ds_pet, ds_ct, pids

        j, t = full_pair
        kw = dict(datasets=("stanford_dataset",), loader=loader,
                  progress=lambda *_: None)
        w_jax = jex.extract_tfds_dataset(tmp_path / "jax", j,
                                         process_grid=(0, 1), **kw)
        w_port = tex.extract_tfds_dataset(tmp_path / "port", t, **kw)
        assert {p.rsplit("/", 1)[-1] for p in w_port} == {
            "p0_ct.parquet", "p0_pet.parquet", "p1_ct.parquet",
            "p1_pet.parquet"}
        _assert_same_stores(tmp_path / "jax", tmp_path / "port", w_jax,
                            w_port)

    def test_tfds_without_the_package_raises(self, monkeypatch):
        monkeypatch.setattr(t_ingest, "HAS_TFDS", False)
        with pytest.raises(ImportError, match="tensorflow_datasets"):
            t_ingest.load_tfds_pair("stanford_dataset", None)

    def test_multi_process_tfds_refused(self, full_pair, tmp_path):
        with pytest.raises(NotImplementedError, match="distributed"):
            tex.extract_tfds_dataset(tmp_path, full_pair[1],
                                     loader=lambda *a: ({}, {}, []),
                                     process_grid=(0, 2))


def _stream(rng, modality, label, n_slices=2, size=48):
    """Per-slice sample dicts as a tfds dataset yields them (the fixture of
    tests/test_cli.py::test_extract_cli_tfds_mode)."""
    samples = []
    for _ in range(n_slices):
        if modality == "ct":
            img = rng.normal(-500, 300, size=(size, size)).astype(np.float32)
        else:
            img = np.abs(rng.normal(0.6, 0.3, size=(size, size))).astype(
                np.float32)
        mask = np.zeros((size, size), bool)
        mask[16:32, 16:32] = True
        s = {"img_exam": img, "mask_exam": mask,
             "egfr_label": np.int64(label),
             "exam_metadata": {
                 "space_directions": np.asarray([0.7, 0.7, 1.2])}}
        if modality == "pet":
            liver = np.zeros((4, 4), np.float32)
            liver[1:3, 1:3] = 2.0
            s["pet_liver"] = liver
        samples.append(s)
    return samples


def _tfds_source():
    rng = np.random.default_rng(5)
    labels = {"p0": 0, "p1": 1, "p2": 2}
    return ({p: _stream(rng, "pet", l) for p, l in labels.items()},
            {p: _stream(rng, "ct", l) for p, l in labels.items()},
            sorted(labels))


class TestCheckpoints:
    TINY = dict(image_size=56, depth=2)     # ViT-S's width, 2 blocks

    @staticmethod
    def _hf_names(sd, depth):
        """The port's (torch.hub) names → transformers' DINOv2 names."""
        hf = {
            "embeddings.patch_embeddings.projection.weight":
                sd["patch_embed.proj.weight"],
            "embeddings.patch_embeddings.projection.bias":
                sd["patch_embed.proj.bias"],
            "embeddings.cls_token": sd["cls_token"],
            "embeddings.position_embeddings": sd["pos_embed"],
            "embeddings.mask_token": torch.zeros(1, sd["cls_token"].shape[-1]),
            "layernorm.weight": sd["norm.weight"],
            "layernorm.bias": sd["norm.bias"],
        }
        for i in range(depth):
            t, h = f"blocks.{i}.", f"encoder.layer.{i}."
            for kind in ("weight", "bias"):
                for src, dst in (("norm1", "norm1"), ("norm2", "norm2"),
                                 ("mlp.fc1", "mlp.fc1"),
                                 ("mlp.fc2", "mlp.fc2"),
                                 ("attn.proj", "attention.output.dense")):
                    hf[f"{h}{dst}.{kind}"] = sd[f"{t}{src}.{kind}"]
                q, k, v = sd[f"{t}attn.qkv.{kind}"].chunk(3)
                hf[f"{h}attention.attention.query.{kind}"] = q
                hf[f"{h}attention.attention.key.{kind}"] = k
                hf[f"{h}attention.attention.value.{kind}"] = v
            hf[h + "layer_scale1.lambda1"] = sd[t + "ls1.gamma"]
            hf[h + "layer_scale2.lambda1"] = sd[t + "ls2.gamma"]
        return hf

    @pytest.mark.parametrize("naming", ["hub", "hf"])
    def test_loader_matches_jax_dinov2_params_from_torch(self, naming,
                                                         tmp_path):
        """A ``.pth`` under torch.hub's or transformers' names: the port's
        ``load_dinov2_state_dict`` into its model and JAX's
        ``dinov2_params_from_torch`` into JAX's give outputs within 2e-5;
        an extractor reads the same file through ``model_path`` in both
        modes."""
        j_cfg = dataclasses.replace(jvit.DINOV2_CONFIGS["dinov2_vits14"],
                                    **self.TINY)
        t_cfg = dataclasses.replace(tvit.DINOV2_CONFIGS["dinov2_vits14"],
                                    **self.TINY)
        rng = np.random.default_rng(9)
        img = rng.uniform(size=(2, 56, 56, 3)).astype(np.float32)
        params = _random_layerscale(jvit.ViTDense(
            j_cfg, policy=J_PARITY, use_flash=False).init(
                jax.random.PRNGKey(0), jnp.asarray(img)), seed=9)
        sd = dinov2_params_from_jax(params, t_cfg)
        sd["mask_token"] = torch.zeros(1, t_cfg.width)   # dropped on load
        if naming == "hf":
            sd = self._hf_names(sd, t_cfg.depth)
        path = tmp_path / "dinov2.pth"
        torch.save(sd, path)

        model = tvit.ViTDense(t_cfg, policy=tex.get_policy("parity"),
                              use_flash=False)
        model.load_state_dict(load_dinov2_state_dict(str(path)))
        with torch.no_grad():
            got = model(torch.from_numpy(img)).numpy()
        j_params = {"params": j_convert.dinov2_params_from_torch(
            j_convert.load_torch_state_dict(str(path)), j_cfg)}
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jvit.ViTDense(
                j_cfg, policy=J_PARITY, use_flash=False).apply(
                    j_params, jnp.asarray(img)))
        np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=FEAT_TOL)

        for mode in ("full", "patch_embed"):
            t = tex.DenseExtractor(
                tex.ExtractionConfig(**dict(RUN, dinov2_mode=mode,
                                            image_size=56,
                                            model_path=str(path))),
                backbone_cfg=None if mode == "patch_embed" else t_cfg,
                device="cpu")
            for k, v in t.model.state_dict().items():
                torch.testing.assert_close(v, model.state_dict()[k],
                                           rtol=0, atol=0)

    def test_patch_embed_tree_bridges(self):
        """JAX's patch_embed-only tree holds the patch embedding alone, and
        so does the bridged state dict; the port's model takes it."""
        cfg = dataclasses.replace(tvit.DINOV2_CONFIGS["dinov2_vits14"],
                                  image_size=28)
        j_cfg = dataclasses.replace(jvit.DINOV2_CONFIGS["dinov2_vits14"],
                                    image_size=28)
        img = np.random.default_rng(10).uniform(size=(1, 28, 28, 3)).astype(
            np.float32)
        j_model = jvit.ViTDense(j_cfg, policy=J_PARITY, use_flash=False,
                                patch_embed_only=True)
        params = j_model.init(jax.random.PRNGKey(1), jnp.asarray(img))
        sd = dinov2_params_from_jax(params, cfg)
        assert sorted(sd) == ["patch_embed.proj.bias",
                              "patch_embed.proj.weight"]
        model = tvit.ViTDense(cfg, policy=tex.get_policy("parity"),
                              patch_embed_only=True)
        model.load_state_dict(sd)
        with torch.no_grad():
            got = model(torch.from_numpy(img)).numpy()
        with jax.default_matmul_precision("highest"):
            want = np.asarray(j_model.apply(params, jnp.asarray(img)))
        np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=FEAT_TOL)


class TestCli:
    @pytest.mark.parametrize("mode", ["full", "patch_embed"])
    def test_isotropic_dinov2_runs(self, mode, tmp_path):
        """Single-device twin of tests/test_cli.py::
        test_extract_cli_pipelined_full_dinov2, in both modes, on the
        CPU."""
        h5, csv = _sweep_inputs(tmp_path)
        rc = t_cli.main([
            "-mn", "dinov2_vits14", "--dinov2-mode", mode,
            "-h5", str(h5), "-df", str(csv), "-f", str(tmp_path / "f"),
            "-mod", "ct", "--datasets", "stanford", "--precision", "parity",
            "--image-size", "28", "--no-flash", "--device", "cpu"])
        assert rc == 0
        assert (tmp_path / "f" / "features_masks_ct.hdf5").exists()
        assert len(list((tmp_path / "f").glob("*/*.parquet"))) == 4

    def test_tfds_source_runs(self, tmp_path, monkeypatch):
        """Twin of tests/test_cli.py::test_extract_cli_tfds_mode: ``--source
        tfds`` through the default loader, replaced by duck-typed streams;
        the label-2 patient is skipped. The JAX CLI on the same streams
        writes the same parquets."""
        ds_pet, ds_ct, pids = _tfds_source()

        def fake_loader(dataset_name, data_dir):
            assert dataset_name == "stanford_dataset"
            assert data_dir == "tfds-dir"
            return ds_pet, ds_ct, pids

        monkeypatch.setattr(t_ingest, "load_tfds_pair", fake_loader)
        monkeypatch.setattr(j_ingest, "load_tfds_pair", fake_loader)
        argv = ["--source", "tfds", "--data-dir", "tfds-dir",
                "-mn", "dinov2_vits14", "-mod", "ct",
                "--datasets", "stanford", "--precision", "parity",
                "--image-size", "28", "--no-flash"]
        assert t_cli.main(argv + ["-f", str(tmp_path / "port"),
                                  "--device", "cpu"]) == 0
        assert j_cli.main(argv + ["-f", str(tmp_path / "jax"),
                                  "--no-data-parallel"]) == 0
        names = {p.name for p in (tmp_path / "port").glob("*/*.parquet")}
        assert names == {"p0_ct.parquet", "p0_pet.parquet",
                         "p1_ct.parquet", "p1_pet.parquet"}
        import pandas as pd

        for p in (tmp_path / "port").glob("*/*.parquet"):
            pd.testing.assert_frame_equal(
                pd.read_parquet(p),
                pd.read_parquet(tmp_path / "jax" / p.parent.name / p.name))
