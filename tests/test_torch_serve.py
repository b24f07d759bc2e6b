"""Port vs JAX: serving artifacts (``engine/serve.py``) and the serve CLI.

The same weights (JAX initialised, carried to the port by
``models/convert.py``) go through JAX's ``export_*`` (``use_flash=False``
on the CPU, as tests/test_serve.py runs them) and the port's; the two
loaded artifacts take the same numpy inputs.

* Dense: ``parity`` within 2e-5 of JAX's artifact; ``fast`` held as
  tests/test_torch_vit.py holds the SAM forward (the port's gap to JAX no
  more than twice JAX ``fast``'s own gap to its fp32 oracle, and 6e-2
  absolute); a round trip equals, bit for bit, a ``ViTDense`` built from
  the baked state dict.
* Classifiers (unimodal, bimodal, conv, ``poly``) and pipelines
  (transformer, conv, bimodal; ``rgb`` and ``raw_hu`` for a MedSAM and a
  DINOv2 backbone, PET normalisation) within 2e-5 under ``parity``
  (JAX's compiled HU→RGB differs from its eager trunc by a whole /255 step
  at a few pixels: that chain is held at tests/test_serve.py's 1e-2 /
  1e-3, and to JAX's eager preprocessing at 2e-5). Under ``fast``
  (classifier exports keep fp32 weights, pipelines bake both models to
  bf16 on both sides: the classifiers' first run with bf16 parameters)
  within 2e-2 absolute and relative: measured 1.56e-2 at most, one bf16
  step of an embedding value near 2.4 (unimodal ``poly`` and pipeline);
  bimodal 3.4e-3 and 5.8e-3, conv 4.9e-4.
* Tokens: ``tokens_one`` in JAX's trainer order exactly, values to 1e-6.
* Headers carry every key of JAX's header with JAX's values (only
  ``platforms`` names other device types).
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.core.precision import get_policy as j_policy
from vit_deep_radiomics_tpu.data import datasets as jds
from vit_deep_radiomics_tpu.engine import serve as jserve
from vit_deep_radiomics_tpu.models import vit as jvit
from vit_deep_radiomics_tpu.models.classifiers import \
    build_classifier as j_build
from vit_deep_radiomics_tpu.utils import native as jnative
from vit_deep_radiomics_tpu_torch.cli import serve as cli
from vit_deep_radiomics_tpu_torch.core.precision import cast_params
from vit_deep_radiomics_tpu_torch.data import datasets as tds
from vit_deep_radiomics_tpu_torch.engine import serve as S
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.models.classifiers import \
    build_classifier as t_build
from vit_deep_radiomics_tpu_torch.models.classifiers import init_classifier
from vit_deep_radiomics_tpu_torch.models.convert import (
    classifier_params_from_jax,
    params_from_jax,
)

# tests/test_torch_vit.py's SAM shape: two heads of 64, window and global
# layers, random rel-pos tables
DENSE = dict(image_size=64, patch_size=8, width=128, depth=3, num_heads=2,
             window_size=4, global_indexes=(1,), neck_channels=32)
# tests/test_serve.py's pipeline backbone (16-channel neck = the
# classifiers' feature_dim), named as extraction names it
PIPE = dict(image_size=32, width=64, depth=2, num_heads=2, window_size=2,
            global_indexes=(1,), neck_channels=16, name="medsam")
# a DINOv2-shaped backbone of the same width (CT through HU→RGB)
DINO = dict(image_size=28, width=16, depth=1, num_heads=2)
D = 16
_LAYER = {"num_layers": 1, "num_heads": 2, "mlp_ratio": 2}
CFG = {"models": {
    "transformer": {"feature_dim": D, "ct": _LAYER, "pet": _LAYER,
                    "chest": _LAYER},
    "conv": {"feature_dim": D, "ct": {"div": 2}, "pet": {"div": 2}},
}}
PARITY_TOL = 2e-5
FAST_CLS_TOL = 2e-2


def _cfgs(base_j, base_t, **kw):
    return dataclasses.replace(base_j, **kw), dataclasses.replace(base_t,
                                                                  **kw)


J_DENSE, T_DENSE = _cfgs(jvit.SAM_VIT_B, tvit.SAM_VIT_B, **DENSE)
J_PIPE, T_PIPE = _cfgs(jvit.SAM_VIT_B, tvit.SAM_VIT_B, **PIPE)
J_DINO, T_DINO = _cfgs(jvit.DINOV2_CONFIGS["dinov2_vits14"],
                       tvit.DINOV2_CONFIGS["dinov2_vits14"], **DINO)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    """JAX's exports trace the parameters: hand them over as jax arrays."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _outs(got):
    got = got if isinstance(got, (tuple, list)) else (got,)
    return [g.numpy() if torch.is_tensor(g) else np.asarray(g) for g in got]


def _close(got, want, tol):
    for a, b in zip(_outs(got), _outs(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _max_gap(got, want):
    return max(np.abs(a - b).max() for a, b in zip(_outs(got), _outs(want)))


def _backbone_params(cfg, rng, seed=0):
    params = jvit.ViTDense(cfg, policy=j_policy("parity"),
                           use_flash=False).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32))
    params = _np(params)
    for i in range(cfg.depth):
        attn = params["params"][f"block_{i}"]["attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            if name in attn:
                attn[name] = (rng.normal(size=attn[name].shape) * 0.5
                              ).astype(np.float32)
    return params


def _clf_inputs(rng, arch, modality, b, t=8, conv=(3, 4, 4)):
    if arch == "conv":
        return [rng.normal(size=(b, *conv, D)).astype(np.float32),
                rng.random((b, *conv)) > 0.2]
    tok = [rng.normal(size=(b, t, D)).astype(np.float32)]
    mask = [rng.random((b, t)) > 0.3]
    if modality == "petct":
        return tok * 2 + [mask[0], rng.random((b, t)) > 0.3]
    return tok + mask


def _clf_params(arch, modality, inputs, seed=1):
    m = j_build(CFG, arch, modality, policy=j_policy("parity"))
    jin = [jnp.asarray(x) for x in inputs]
    if modality == "petct":
        v = m.init(jax.random.PRNGKey(seed), ct_tokens=jin[0],
                   pet_tokens=jin[1], ct_mask=jin[2], pet_mask=jin[3])
    else:
        v = m.init(jax.random.PRNGKey(seed), *jin)
    return _np(v)


# --------------------------------------------------------------- dense


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dense")
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    params = _backbone_params(J_DENSE, rng)
    sd = params_from_jax(params, T_DENSE)
    out = {}
    for pol in ("parity", "fast"):
        jp = jserve.export_dense_model(_jnp(params), J_DENSE, tmp / f"j_{pol}.vdr",
                                       batch=2, policy=pol, use_flash=False)
        tp = S.export_dense_model(sd, T_DENSE, tmp / f"t_{pol}.vdr", batch=2,
                                  policy=pol)
        out[pol] = (jp, tp, np.asarray(jserve.load_exported(jp)(img)))
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jvit.ViTDense(J_DENSE, policy=j_policy("parity"),
                                          use_flash=False).apply(
            params, jnp.asarray(img)))
    return img, sd, out, oracle


class TestDense:
    @pytest.mark.parametrize("policy", ["parity", "fast"])
    def test_roundtrip_equals_module_on_baked_weights(self, dense, policy):
        """The loaded artifact is a ViTDense on the baked state dict: bf16
        under ``fast`` (every tensor), fp32 under ``parity``."""
        img, sd, out, _ = dense
        model = S.load_exported(out[policy][1], device="cpu")
        dt = torch.bfloat16 if policy == "fast" else torch.float32
        assert {v.dtype for v in model.module.state_dict().values()} == {dt}
        ref = tvit.ViTDense(T_DENSE, policy=S.get_policy(policy)).to(dt)
        ref.load_state_dict(cast_params(sd, dt))
        with torch.no_grad():
            want = ref(torch.from_numpy(img))
        got = model(img)
        assert torch.equal(got, want)
        assert got.shape == (2, 8, 8, 32) and torch.is_inference(got)

    def test_parity_matches_jax_artifact(self, dense):
        img, _, out, _ = dense
        got = S.load_exported(out["parity"][1], device="cpu")(img)
        _close(got, out["parity"][2], PARITY_TOL)

    def test_fast_matches_jax_artifact(self, dense):
        """The port's gap to JAX's ``fast`` artifact at most twice JAX
        ``fast``'s own gap to the fp32 oracle, and 6e-2 absolute."""
        img, _, out, oracle = dense
        got = S.load_exported(out["fast"][1], device="cpu")(img).numpy()
        want = out["fast"][2]
        jax_gap = np.abs(want - oracle).max()
        port_gap = np.abs(got - want).max()
        assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)
        np.testing.assert_allclose(got, want, atol=6e-2)

    @pytest.mark.parametrize("policy", ["parity", "fast"])
    def test_header_is_a_superset_of_jax(self, dense, policy, tmp_path):
        """The same export (``use_flash=False`` on both sides): JAX's
        keys and values, only ``platforms`` names device types."""
        jp, tp, _ = dense[2][policy]
        _same_header(jserve.load_exported(jp).meta, S.read_header(tp))
        same = S.export_dense_model(dense[1], T_DENSE, tmp_path / "o.vdr",
                                    batch=2, policy=policy, use_flash=False)
        _same_header(jserve.load_exported(jp).meta, S.read_header(same),
                     differ=("platforms",))

    def test_wrong_input_refused(self, dense):
        model = S.load_exported(dense[2]["parity"][1], device="cpu")
        with pytest.raises(ValueError, match="shape"):
            model(np.zeros((3, 64, 64, 3), np.float32))
        with pytest.raises(TypeError, match="float32"):
            model(np.zeros((2, 64, 64, 3), np.float64))

    def test_each_package_refuses_the_others_artifact(self, dense, tmp_path):
        jp, tp, _ = dense[2]["parity"]
        with pytest.raises(ValueError, match="not a VDR export"):
            S.load_exported(jp, device="cpu")
        with pytest.raises(ValueError, match="not a VDR export"):
            jserve.load_exported(tp)
        junk = tmp_path / "junk.vdr"
        junk.write_bytes(b"NOTVDR00junkjunk")
        with pytest.raises(ValueError, match="not a VDR export"):
            S.read_header(junk)

    def test_device_and_platform_refusals(self, dense, tmp_path,
                                          monkeypatch):
        _, sd, out, _ = dense
        with pytest.raises(ValueError, match="TPU"):
            S.export_dense_model(sd, T_DENSE, tmp_path / "x.vdr",
                                 platforms=("cpu", "tpu"))
        only = S.export_dense_model(sd, T_DENSE, tmp_path / "cuda.vdr",
                                    batch=2, platforms=("cuda",))
        assert S.read_header(only)["platforms"] == ["cuda"]
        with pytest.raises(ValueError, match="exported for"):
            S.load_exported(only, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.load_exported(out["parity"][1])

    def test_export_refusals(self, dense, tmp_path):
        _, sd, _, _ = dense
        with pytest.raises(ValueError, match="patch-embed-only"):
            S.export_dense_model({}, T_DENSE, tmp_path / "x.vdr",
                                 policy="int8", patch_embed_only=True)
        bad = {k: v for k, v in sd.items() if k != "neck.0.weight"}
        with pytest.raises(ValueError, match="neck.0.weight"):
            S.export_dense_model(bad, T_DENSE, tmp_path / "x.vdr")


def _same_header(jmeta, tmeta, differ=("platforms", "use_flash")):
    """Every key of JAX's header, with JAX's value, except ``platforms``
    (device types) and, by default, ``use_flash`` (JAX exports the oracle
    path on the CPU, the port its kernel path)."""
    assert set(jmeta) <= set(tmeta), set(jmeta) - set(tmeta)
    for key, value in jmeta.items():
        if key not in differ:
            assert tmeta[key] == value, key
    assert tmeta["format"] == S.FORMAT


class TestKernelEnv:
    @pytest.mark.parametrize("at_export", ["1", None])
    def test_header_governs_routing(self, dense, tmp_path, monkeypatch,
                                    at_export):
        """``VDR_FUSED_MLP`` is recorded as JAX records it and routes the
        loaded model whatever the serving environment says, in both
        directions: the output equals a module run under the export's
        setting bit for bit."""
        img, sd, _, _ = dense
        if at_export is None:
            monkeypatch.delenv("VDR_FUSED_MLP", raising=False)
        else:
            monkeypatch.setenv("VDR_FUSED_MLP", at_export)
        path = S.export_dense_model(sd, T_DENSE, tmp_path / "k.vdr",
                                    batch=2, policy="fast")
        fused = at_export == "1"
        assert S.read_header(path).get("kernel_env") == (
            {"VDR_FUSED_MLP": "1"} if fused else None)
        with torch.no_grad():
            want = S.load_exported(path, device="cpu").module(
                torch.from_numpy(img))
        # serve under the opposite environment
        if fused:
            monkeypatch.delenv("VDR_FUSED_MLP")
        else:
            monkeypatch.setenv("VDR_FUSED_MLP", "1")
        model = S.load_exported(path, device="cpu")
        calls, k7 = [], tvit.fused_ln_mlp_residual

        def counted(*args, **kw):
            calls.append(1)
            return k7(*args, **kw)

        monkeypatch.setattr(tvit, "fused_ln_mlp_residual", counted)
        assert torch.equal(model(img), want)
        assert len(calls) == (T_DENSE.depth if fused else 0)
        # a live module follows the environment instead
        live = tvit.ViTDense(T_DENSE)
        assert all(b._fused_mlp_on(live.policy) is not fused
                   for b in live.blocks)


@pytest.mark.parametrize("before,during,status", [
    ([], [], "hit"),
    ([], [("fused_window_attention", 1.5)], "miss-saved"),
    ([], [("fused_window_attention", 1.5), ("fused_global_attention", 2.0)],
     "miss-saved"),
    ([("fused_window_attention", 3.0)], [], "hit"),
    ([("fused_window_attention", 3.0)], [("fused_global_attention", 2.0)],
     "miss-saved"),
])
def test_warm_reports_the_builds_of_its_call(dense, monkeypatch, before,
                                             during, status):
    """Kernels build on their first launch: ``warm()`` reads
    ``cache_status`` and ``warm_stats`` from the builds its zero-input call
    ran, not from those before it, and a second ``warm()`` calls nothing."""
    from vit_deep_radiomics_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILDS", list(before))
    model = S.load_exported(dense[2]["parity"][1], device="cpu")
    forward, calls = model.module.forward, []

    def building(*args):          # what the first launches would record
        calls.append(args[0].shape)
        cuda_build.BUILDS.extend(during)
        return forward(*args)

    monkeypatch.setattr(model.module, "forward", building)
    assert model.warm() is model and model.warm() is model
    assert calls == [(2, 64, 64, 3)]
    assert model.cache_status == status
    assert model.warm_stats["built"] == [n for n, _ in during]
    assert model.warm_stats["warm_build_s"] == round(
        sum(s for _, s in during), 2)
    assert set(model.warm_stats) == {"built", "warm_build_s",
                                     "warm_first_exec_s"}


# ---------------------------------------------------------- classifiers


CLASSIFIERS = [("transformer", "ct", 2), ("transformer", "petct", 2),
               ("conv", "ct", 2), ("transformer", "ct", "poly")]


class TestClassifier:
    @pytest.mark.parametrize("arch,modality,batch", CLASSIFIERS)
    @pytest.mark.parametrize("policy", ["parity", "fast"])
    def test_matches_jax_artifact(self, tmp_path, arch, modality, batch,
                                  policy):
        rng = np.random.default_rng(3)
        b = 3 if batch == "poly" else 2
        inputs = _clf_inputs(rng, arch, modality, b)
        v = _clf_params(arch, modality, inputs)
        kw = dict(batch=batch, max_tokens=8, conv_shape=(3, 4, 4),
                  policy=policy)
        jp = jserve.export_classifier(_jnp(v), CFG, arch, modality,
                                      tmp_path / "j.vdr", **kw)
        tp = S.export_classifier({"params": classifier_params_from_jax(v)},
                                 CFG, arch, modality, tmp_path / "t.vdr",
                                 **kw)
        jm = jserve.load_exported(jp)
        tm = S.load_exported(tp, device="cpu").warm()
        assert tm.cache_status == ("poly" if batch == "poly" else "hit")
        _same_header(jm.meta, S.read_header(tp))
        got, want = tm(*inputs), jm(*inputs)
        _close(got, want, PARITY_TOL if policy == "parity"
               else FAST_CLS_TOL)

    def test_int8_refused(self, tmp_path):
        with pytest.raises(ValueError, match="int8"):
            S.export_classifier({}, CFG, "transformer", "ct",
                                tmp_path / "x.vdr", policy="int8")


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipe():
    rng = np.random.default_rng(7)
    return {"medsam": _backbone_params(J_PIPE, rng),
            "dinov2": _backbone_params(J_DINO, rng, seed=2)}


PIPES = {
    # name: (backbone, arch, modality, input_mode)
    "transformer": ("medsam", "transformer", "ct", "rgb"),
    "conv": ("medsam", "conv", "ct", "rgb"),
    "bimodal": ("medsam", "transformer", "petct", "rgb"),
    "raw_medsam_ct": ("medsam", "transformer", "ct", "raw_hu"),
    "raw_dinov2_ct": ("dinov2", "transformer", "ct", "raw_hu"),
    "raw_dinov2_pet": ("dinov2", "transformer", "pet", "raw_hu"),
    "raw_bimodal": ("medsam", "transformer", "petct", "raw_hu"),
}


def _pipe_inputs(rng, cfg, modality, raw, s=3, ps=2):
    g = cfg.grid

    def images(n, native, pet=False):
        if not raw:
            return rng.uniform(size=(1, n, cfg.image_size, cfg.image_size,
                                     3)).astype(np.float32)
        if pet:
            return rng.uniform(0.1, 9.0, size=(1, n, native, native)
                               ).astype(np.float32)
        return rng.integers(-1024, 1500, size=(1, n, native, native)
                            ).astype(np.int16)

    def mask(n):
        m = rng.random((1, n, g, g)) > 0.5
        m[0, 0, 0, 0] = True
        return m

    ct_res = np.asarray([[1.5, 2.0, 3.5]], np.float32)
    if modality == "petct":
        return [images(s, 24), images(ps, 16, pet=True), mask(s), mask(ps),
                ct_res, np.asarray([[4.0, 4.0, 5.0]], np.float32)]
    return [images(s, 24, pet=modality == "pet"), mask(s), ct_res]


def _export_pair(tmp_path, pipe, name, policy, input_mode=None):
    backbone, arch, modality, mode = PIPES[name]
    mode = input_mode or mode
    jcfg, tcfg = (J_PIPE, T_PIPE) if backbone == "medsam" else (J_DINO,
                                                                T_DINO)
    clf_in = (_clf_inputs(np.random.default_rng(0), arch, modality, 1,
                          conv=(3, jcfg.grid, jcfg.grid)))
    v = _clf_params(arch, modality, clf_in)
    params = pipe[backbone]
    kw = dict(slices=3, pet_slices=2, max_tokens=12, batch=1, policy=policy,
              input_mode=mode, native_size=24, pet_native_size=16)
    jp = jserve.export_pipeline(_jnp(params), jcfg, _jnp(v), CFG, arch,
                                modality,
                                tmp_path / "j.vdr", use_flash=False, **kw)
    tp = S.export_pipeline(params_from_jax(params, tcfg), tcfg,
                           classifier_params_from_jax(v), CFG, arch,
                           modality, tmp_path / "t.vdr", **kw)
    return jp, tp, jcfg, modality, mode


class TestPipeline:
    @pytest.mark.parametrize("name", sorted(PIPES))
    def test_parity_matches_jax_artifact(self, tmp_path, pipe, name):
        jp, tp, jcfg, modality, mode = _export_pair(tmp_path, pipe, name,
                                                    "parity")
        jm = jserve.load_exported(jp)
        tm = S.load_exported(tp, device="cpu").warm()
        _same_header(jm.meta, S.read_header(tp))
        inputs = _pipe_inputs(np.random.default_rng(11), jcfg, modality,
                              mode == "raw_hu")
        if name == "raw_dinov2_ct":
            # JAX's compiled HU→RGB rounds a few pixels a whole /255 step
            # off its eager (and the port's) trunc: tests/test_serve.py's
            # tolerance for that chain; the next test holds the rest
            np.testing.assert_allclose(*_outs(tm(*inputs))[:1],
                                       *_outs(jm(*inputs))[:1],
                                       rtol=1e-2, atol=1e-3)
            return
        _close(tm(*inputs), jm(*inputs), PARITY_TOL)

    def test_raw_hu_to_rgb_equals_eager_preprocessing(self, tmp_path,
                                                       pipe):
        """The port's in-graph HU→RGB / 255 and resize equal JAX's eager
        chain: its raw artifact against JAX's rgb artifact fed that
        chain's images, within 2e-5."""
        from vit_deep_radiomics_tpu.ops import preprocess as jpp

        _, tp, jcfg, _, _ = _export_pair(tmp_path, pipe, "raw_dinov2_ct",
                                         "parity")
        jp = _export_pair(tmp_path / "rgb", pipe, "raw_dinov2_ct",
                          "parity", input_mode="rgb")[0]
        hu, mask, res = _pipe_inputs(np.random.default_rng(11), jcfg, "ct",
                                     True)
        rgb = np.asarray(jpp.prepare_vit_input(
            jpp.hu_to_rgb(jnp.asarray(hu[0])).astype(jnp.float32) / 255.0,
            jcfg.image_size))[None]
        _close(S.load_exported(tp, device="cpu")(hu, mask, res),
               jserve.load_exported(jp)(rgb, mask, res), PARITY_TOL)

    @pytest.mark.parametrize("name", ["transformer", "conv",
                                      "raw_bimodal"])
    def test_fast_matches_jax_artifact(self, tmp_path, pipe, name):
        """Backbone and classifier baked to bf16 on both sides."""
        jp, tp, jcfg, modality, mode = _export_pair(tmp_path, pipe, name,
                                                    "fast")
        tm = S.load_exported(tp, device="cpu")
        assert {v.dtype for v in tm.module.state_dict().values()} == {
            torch.bfloat16}
        inputs = _pipe_inputs(np.random.default_rng(12), jcfg, modality,
                              mode == "raw_hu")
        _close(tm(*inputs), jserve.load_exported(jp)(*inputs),
               FAST_CLS_TOL)

    def test_sam_named_as_sam_vit_b_takes_the_hu_window(self, tmp_path,
                                                         pipe):
        """Extraction and the port window MedSAM's CT by the model, not by
        the config's name: ``SAM_VIT_B`` ("sam_vit_b", what ``-mn medsam``
        builds) serves as JAX serves a config named "medsam"."""
        jp, _, jcfg, modality, mode = _export_pair(
            tmp_path, pipe, "raw_medsam_ct", "parity")
        cfg = dataclasses.replace(T_PIPE, name="sam_vit_b")
        clf = _clf_params("transformer", "ct", _clf_inputs(
            np.random.default_rng(0), "transformer", "ct", 1))
        tp = S.export_pipeline(
            params_from_jax(pipe["medsam"], cfg), cfg,
            classifier_params_from_jax(clf), CFG, "transformer", "ct",
            tmp_path / "named.vdr", slices=3, max_tokens=12,
            policy="parity", input_mode="raw_hu", native_size=24)
        assert S.read_header(tp)["ct_preprocess"] == "window"
        inputs = _pipe_inputs(np.random.default_rng(13), jcfg, modality,
                              True)
        _close(S.load_exported(tp, device="cpu")(*inputs),
               jserve.load_exported(jp)(*inputs), PARITY_TOL)

    def test_refusals(self, tmp_path):
        with pytest.raises(ValueError, match="transformer"):
            S.export_pipeline({}, T_PIPE, {}, CFG, "conv", "petct",
                              tmp_path / "x.vdr")
        with pytest.raises(ValueError, match="input_mode"):
            S.export_pipeline({}, T_PIPE, {}, CFG, "transformer", "ct",
                              tmp_path / "x.vdr", input_mode="jpeg")
        bad = {"models": {"transformer": {**CFG["models"]["transformer"],
                                          "feature_dim": 32}}}
        with pytest.raises(ValueError, match="feature_dim"):
            S.export_pipeline({}, T_PIPE, {"params": {}}, bad,
                              "transformer", "ct", tmp_path / "x.vdr")


class TestTokens:
    def test_tokens_one_follows_the_trainers(self, monkeypatch):
        """JAX's and the port's trainer tokens (numpy path, the feature
        grid as the original grid, no noise): the masked voxels in (h, w,
        slice) order, each descriptor plus the encoding / 4, within 1e-6;
        the rest of the budget zero and invalid."""
        rng = np.random.default_rng(5)
        s, g, t = 3, 4, 40
        feats = rng.normal(size=(s, g, g, D)).astype(np.float32)
        mask = rng.random((s, g, g)) > 0.5
        res = np.asarray([1.5, 2.0, 3.5], np.float32)
        monkeypatch.setattr(jnative, "available", lambda: False)
        jset = object.__new__(jds.PETCTDataset)
        jset.arch, jset.feature_dim = "transformer", D
        jset._read_features = lambda *a: (list(feats), list(mask))
        want, _ = jset._get_features(None, None, None, np.zeros(3), res)
        n = int(mask.sum())
        assert want.shape == (n, D)
        tok, valid = S.tokens_one(torch.from_numpy(feats),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(res), t)
        assert valid.tolist() == [True] * n + [False] * (t - n)
        np.testing.assert_allclose(tok[:n].numpy(), want, atol=1e-6,
                                   rtol=1e-6)
        assert not tok[n:].any()
        np.testing.assert_allclose(
            tds.voxel_tokens(feats, mask.astype(np.float32), (g, g), res),
            want, atol=1e-6, rtol=1e-6)

    def test_token_order_is_exact(self):
        """With zero spacing every encoding is the same vector, so the
        descriptors (each voxel's id) read back the order: the trainer's
        boolean select, (h, w, slice); past the budget cut short."""
        s, g, t = 2, 3, 7
        ids = np.arange(s * g * g, dtype=np.float32).reshape(s, g, g)
        feats = np.repeat(ids[..., None], D, axis=-1)
        mask = np.random.default_rng(6).random((s, g, g)) > 0.4
        tok, valid = S.tokens_one(torch.from_numpy(feats),
                                  torch.from_numpy(mask),
                                  torch.zeros(3), t)
        order = ids.transpose(1, 2, 0).reshape(-1)[
            mask.transpose(1, 2, 0).reshape(-1)]
        n = min(t, order.size)
        pe0 = S.positional_encoding_3d(torch.zeros(1), torch.zeros(1),
                                       torch.zeros(1), D)[0] / 4.0
        got = torch.round(tok[:n] - pe0)[:, 0].numpy()
        np.testing.assert_array_equal(got, order[:n])
        assert valid[:n].all() and int(valid.sum()) == n


# ------------------------------------------------------ CLI and server


@pytest.fixture
def project(tmp_path, monkeypatch):
    """A project root whose config is CFG with feature_dim 384 (DINOv2
    ViT-S/14's width), and a fold checkpoint of each classifier."""
    from vit_deep_radiomics_tpu_torch.engine import checkpoint
    from vit_deep_radiomics_tpu_torch.utils import config

    cfg = {"models": {arch: {**block, "feature_dim": 384}
                      for arch, block in CFG["models"].items()}}
    monkeypatch.setattr(config, "load_conf", lambda *a, **k: cfg)
    ckpt = {}
    for arch, modality in (("transformer", "ct"), ("transformer", "petct")):
        model = init_classifier(t_build(cfg, arch, modality), seed=3)
        ckpt[modality] = checkpoint.save_checkpoint(
            {"params": model.state_dict(), "epoch": 7},
            tmp_path / modality, 7)
    return tmp_path, cfg, ckpt


class TestCli:
    def test_parser_offers_jax_subcommands_and_flags(self):
        p = cli.build_parser()
        args = p.parse_args(["export-pipeline", "c.pt", "-o", "x",
                             "--input-mode", "raw-hu"])
        assert (args.input_mode, args.slices, args.pet_slices,
                args.device) == ("raw-hu", 13, 2, "cuda")
        args = p.parse_args(["run", "a.vdr", "-i", "x.npz", "-o", "y",
                             "--overlap", "--labels", "l.npy",
                             "--poly-chunk", "4"])
        assert args.overlap and args.poly_chunk == 4
        assert p.parse_args(["export-clf", "c.pt", "-o", "x", "-b",
                             "poly"]).batch == "poly"
        with pytest.raises(SystemExit):
            p.parse_args(["export-clf", "c.pt", "-o", "x", "-b", "0"])

    def test_subcommands_and_flags_are_jaxs(self):
        """Every JAX subcommand with every JAX flag and default; the port
        adds only ``--device`` (and ``run``'s p90 in its report)."""
        from vit_deep_radiomics_tpu.cli import serve as jcli

        def flags(parser):
            sub = next(a for a in parser._actions
                       if a.__class__.__name__ == "_SubParsersAction")
            return {name: {a.dest: (tuple(a.option_strings), a.default)
                           for a in p._actions if a.dest != "help"}
                    for name, p in sub.choices.items()}

        ref, got = flags(jcli.build_parser()), flags(cli.build_parser())
        assert set(got) == set(ref)
        for name, opts in ref.items():
            extra = dict(got[name])
            for dest, want in opts.items():
                assert extra.pop(dest) == want, (name, dest)
            assert set(extra) <= {"device"}, (name, extra)

    def test_dense_export_info_run(self, tmp_path, capsys):
        """A DINOv2 ViT-S/14 patch embedding at 28 px: 5 images through
        a batch-2 artifact (padded, cut back) equal the direct call."""
        art = str(tmp_path / "d.vdr")
        assert cli.main(["export", "-mn", "dinov2_vits14", "--dinov2-mode",
                         "patch_embed", "--image-size", "28", "-o", art,
                         "-b", "2", "--precision", "parity",
                         "--device", "cpu"]) == 0
        capsys.readouterr()
        assert cli.main(["info", art]) == 0
        meta = json.loads(capsys.readouterr().out)
        assert (meta["batch"], meta["image_size"], meta["patch_embed_only"],
                meta["out_shape"]) == (2, 28, True, [2, 2, 2, 384])
        images = np.random.default_rng(1).uniform(
            size=(5, 28, 28, 3)).astype(np.float32)
        np.save(tmp_path / "x.npy", images)
        assert cli.main(["run", art, "-i", str(tmp_path / "x.npy"), "-o",
                         str(tmp_path / "y.npy"), "--device", "cpu"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["images"] == 5 and report["exec_cache"] == "hit"
        assert {"latency_p50_ms", "latency_p90_ms"} <= set(report)
        model = S.load_exported(art, device="cpu")
        want = torch.cat([model(images[:2]), model(images[2:4]),
                          model(np.concatenate([images[4:],
                                                np.zeros_like(images[:1])
                                                ]))[:1]])
        np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                      want.numpy())
        np.save(tmp_path / "l.npy", np.zeros(5, np.float32))
        with pytest.raises(SystemExit, match="classifier artifacts"):
            cli.main(["run", art, "-i", str(tmp_path / "x.npy"), "-o",
                      str(tmp_path / "z.npy"), "--labels",
                      str(tmp_path / "l.npy"), "--device", "cpu"])

    def test_run_classifier_pads_and_defaults_masks(self, project, capsys):
        """export-clf from a fold checkpoint (``.pt``); 5 items of 5
        tokens through a batch-2, 8-token artifact with the mask omitted:
        the tokens padded to 8 and masked there, the batch padded and cut
        back; ``--overlap`` gives the same bits; ``--labels`` adds the
        metrics."""
        tmp, cfg, ckpt = project
        art = str(tmp / "c.vdr")
        assert cli.main(["export-clf", ckpt["ct"], "-a", "transformer",
                         "-m", "ct", "-o", art, "-b", "2", "--max-tokens",
                         "8", "--precision", "parity"]) == 0
        rng = np.random.default_rng(2)
        tokens = rng.normal(size=(5, 5, 384)).astype(np.float32)
        np.savez(tmp / "in.npz", tokens=tokens)
        np.save(tmp / "l.npy", np.array([0, 1, 0, 1, 1]))
        outs = []
        for extra in ([], ["--overlap", "--labels", str(tmp / "l.npy")]):
            out = tmp / f"out{len(extra)}.npz"
            capsys.readouterr()
            assert cli.main(["run", art, "-i", str(tmp / "in.npz"), "-o",
                             str(out), "--device", "cpu", *extra]) == 0
            report = json.loads(capsys.readouterr().out)
            assert report["items"] == 5 and report["batch"] == 2
            outs.append(np.load(out))
        assert report["overlap"] is True
        assert set(report["eval"]["logits"]) == {"auc", "accuracy",
                                                 "macro_f1"}
        padded = np.zeros((5, 8, 384), np.float32)
        padded[:, :5] = tokens
        mask = np.zeros((5, 8), bool)
        mask[:, :5] = True
        model = S.load_exported(art, device="cpu")
        want = [torch.cat(x) for x in zip(*(
            model(np.concatenate([padded, padded[:1]])[i:i + 2],
                  np.concatenate([mask, mask[:1]])[i:i + 2])
            for i in (0, 2, 4)))]
        for name, w in zip(("logits", "cls_embedding"), want):
            for o in outs:
                np.testing.assert_array_equal(o[name], w[:5].numpy())
        np.savez(tmp / "bad.npz", tokens=tokens[..., :16])
        with pytest.raises(SystemExit, match="feature dim"):
            cli.main(["run", art, "-i", str(tmp / "bad.npz"), "-o",
                      str(tmp / "b.npz"), "--device", "cpu"])
        np.savez(tmp / "bad.npz", tokens=tokens, extra=tokens)
        with pytest.raises(SystemExit, match="unknown input"):
            cli.main(["run", art, "-i", str(tmp / "bad.npz"), "-o",
                      str(tmp / "b.npz"), "--device", "cpu"])

    def test_export_pipeline_raw_hu_bimodal(self, project, capsys):
        """``export-pipeline --input-mode raw-hu`` with a DINOv2 ViT-S/14
        backbone at 28 px (the whole transformer) and the bimodal
        checkpoint; ``run`` equals a direct call on the same inputs."""
        tmp, cfg, ckpt = project
        art = str(tmp / "p.vdr")
        assert cli.main(["export-pipeline", ckpt["petct"], "-mn",
                         "dinov2_vits14", "--image-size", "28", "-m",
                         "petct", "-o", art, "--slices", "3",
                         "--max-tokens", "8", "--input-mode", "raw-hu",
                         "--native-size", "20", "--pet-native-size", "12",
                         "--device", "cpu"]) == 0
        meta = S.read_header(art)
        assert (meta["input_mode"], meta["ct_preprocess"],
                meta["in_spec"]["pet_images"]) == (
            "raw_hu", "hu_to_rgb", [[1, 2, 12, 12], "float32"])
        rng = np.random.default_rng(4)
        inputs = {"ct_images": rng.integers(-1024, 1500, (2, 3, 20, 20)
                                            ).astype(np.int16),
                  "pet_images": rng.uniform(0.1, 9, (2, 2, 12, 12)
                                            ).astype(np.float32),
                  "ct_grid_mask": rng.random((2, 3, 2, 2)) > 0.3,
                  "pet_grid_mask": rng.random((2, 2, 2, 2)) > 0.3,
                  "ct_res": np.ones((2, 3), np.float32),
                  "pet_res": np.full((2, 3), 4.0, np.float32)}
        np.savez(tmp / "in.npz", **inputs)
        capsys.readouterr()
        assert cli.main(["run", art, "-i", str(tmp / "in.npz"), "-o",
                         str(tmp / "out.npz"), "--device", "cpu"]) == 0
        got = np.load(tmp / "out.npz")
        model = S.load_exported(art, device="cpu")
        for i in range(2):
            want = model(*(v[i:i + 1] for v in inputs.values()))
            for name, w in zip(meta["out_names"], want):
                np.testing.assert_array_equal(got[name][i], w[0].numpy())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


class TestServer:
    def test_dense_health_infer_400_404(self, dense):
        img = dense[0]
        model = S.load_exported(dense[2]["parity"][1], device="cpu").warm()
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli.make_server(model))
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            code, body = _get(url + "/health")
            health = json.loads(body)
            assert (code, health["status"], health["kind"],
                    health["exec_cache"]) == (200, "ok", "dense", "hit")
            buf = io.BytesIO()
            np.savez(buf, images=np.concatenate([img, img[:1]]))
            code, body = _post(url + "/infer", buf.getvalue())
            assert code == 200
            got = np.load(io.BytesIO(body))["features"]
            want = model(img).numpy()
            np.testing.assert_array_equal(got[:2], want)
            np.testing.assert_array_equal(got[2], want[0])
            code, body = _post(url + "/infer", b"not-an-npz")
            assert code == 400 and "error" in json.loads(body)
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(url + "/nope")
            assert exc.value.code == 404
            assert _post(url + "/nope", b"")[0] == 404
            assert _get(url + "/health")[0] == 200
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()

    def test_calls_from_any_thread_build_no_graph(self, dense):
        """Grad mode is per thread: a call from a fresh thread (as a
        server handler's) still runs under inference mode."""
        model = S.load_exported(dense[2]["parity"][1], device="cpu")
        seen = []

        def call():
            torch.set_grad_enabled(True)
            out = model(dense[0])
            seen.append((torch.is_inference(out), out.requires_grad))

        worker = threading.Thread(target=call)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive() and seen == [(True, False)]
