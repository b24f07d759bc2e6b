"""Port vs JAX: backbone fine-tuning (engine/finetune.py, cli/finetune.py).

The JAX ``FineTuner`` on tests/test_finetune.py's ``TINY_SAM`` (its
``parity`` path runs the generic trainable kernels in interpret mode, its
``fast`` path the fused window kernels) and the port's ``FineTuner`` on the
CPU (under ``parity`` the plain versions of K6, under ``fast`` those of
K1, K4 and K5) start from the same weights, bridged by
``models/convert.py::finetune_params_from_jax`` with the rel-pos tables
filled randomly so that the bias gradients count, and see the same
batches. ``parity``: the loss of every step to 1e-4 relative and every
parameter after 3 steps to 1e-4; ``fast``: the loss to 5e-2 relative (both
sides round to bf16 at other places). A tiny DINOv2-shaped backbone (CLS
token, LayerScale, 17 tokens padded to 128 with ``kv_len``) is held to
JAX the same way under ``parity``.

Where a gradient is at fp32 rounding level (the k third of ``qkv.bias``:
it adds a per-row constant under the softmax, so its exact gradient is
zero), AdamW turns each side's rounding noise into updates of about
0.1·LR with that side's signs. The update comparison leaves out the
elements whose first JAX gradient is at that level, and holds the port's
gradient there at that level too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.engine.finetune import (
    FineTuneConfig as JaxConfig,
    FineTuner as JaxTuner,
)
from vit_deep_radiomics_tpu.models.losses import focal_loss as jax_focal_loss
from vit_deep_radiomics_tpu.models.vit import DINOV2_CONFIGS as JAX_DINOV2
from vit_deep_radiomics_tpu.models.vit import SAM_VIT_B as JAX_SAM_VIT_B
from vit_deep_radiomics_tpu_torch.engine.finetune import (
    FineTuneConfig,
    FineTuneModel,
    FineTuner,
)
from vit_deep_radiomics_tpu_torch.models.convert import (
    finetune_params_from_jax,
)
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.models.vit import (
    DINOV2_CONFIGS,
    SAM_VIT_B,
    ViTDense,
)
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

TINY = dict(image_size=64, width=128, depth=3, num_heads=2, window_size=4,
            global_indexes=(1,), neck_channels=32)
TINY_SAM = dataclasses.replace(SAM_VIT_B, **TINY)
JAX_TINY_SAM = dataclasses.replace(JAX_SAM_VIT_B, **TINY)
# DINOv2 ViT-S/14's layout at 56 px: 4x4 patches + CLS = 17 tokens
TINY_DINO_ARGS = dict(image_size=56, width=128, depth=2, num_heads=2)
TINY_DINO = dataclasses.replace(DINOV2_CONFIGS["dinov2_vits14"],
                                **TINY_DINO_ARGS)
JAX_TINY_DINO = dataclasses.replace(JAX_DINOV2["dinov2_vits14"],
                                    **TINY_DINO_ARGS)
STEPS = 3
LR = 1e-5
# fp32 rounding level of a gradient, relative to its leaf's max |grad|:
# the k third of qkv.bias measured at most 6.7e-8 (JAX) and 1.4e-7 (port),
# the smallest q/v element 1.9e-4
ROUNDING = 1e-6


def _batch(seed, b=2, size=64, grid=4):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, size, size, 3)).astype(np.float32)
    mask = np.zeros((b, grid, grid), bool)
    mask[:, 1:3, 1:3] = True
    labels = np.eye(2, dtype=np.float32)[np.arange(b) % 2]
    return images, mask, labels


def _jax_run(precision, batch, backbone=JAX_TINY_SAM, grads=False, **cfg):
    """JAX FineTuner: (initial params, final params, per-step losses),
    and with ``grads`` the first step's gradients."""
    config = JaxConfig(num_classes=2, learning_rate=LR, precision=precision,
                       backbone_cfg=backbone, **cfg)
    tuner = JaxTuner(config)
    params = tuner.init(jax.random.PRNGKey(0), jnp.asarray(batch[0]),
                        jnp.asarray(batch[1]))["params"]
    rng = np.random.default_rng(11)

    def fill(path, leaf):
        # random rel-pos tables, LayerScale gammas and CLS token, so that
        # each of them moves the loss
        name = jax.tree_util.keystr(path)
        if "rel_pos" in name or "cls_token" in name:
            return jnp.asarray(rng.normal(size=leaf.shape).astype(
                np.float32) * 0.2)
        if "'ls1'" in name or "'ls2'" in name:
            return jnp.asarray((0.1 + 0.05 * rng.normal(
                size=leaf.shape)).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    p0 = jax.tree_util.tree_map(np.asarray, params)

    state = {"params": params,
             "opt_state": tuner._optimizer(params).init(params)}
    losses = []
    for _ in range(STEPS):
        state, loss, _ = tuner.step(state, *batch)
        losses.append(float(loss))
    out = p0, jax.tree_util.tree_map(np.asarray, state["params"]), losses
    if grads:
        def loss_fn(p):
            logits = tuner.model.apply(p, *map(jnp.asarray, batch[:2]))
            return jax_focal_loss(logits, jnp.asarray(batch[2]),
                                  alpha=jnp.asarray(config.focal_alpha),
                                  gamma=config.focal_gamma) / len(batch[2])

        out += (jax.tree_util.tree_map(np.asarray,
                                       jax.grad(loss_fn)(p0)),)
    return out


def _port_grads(batch, p0, backbone=TINY_SAM, **cfg):
    """The port's gradients of the first step (None where frozen)."""
    tuner = FineTuner(FineTuneConfig(num_classes=2, precision="parity",
                                     backbone_cfg=backbone, **cfg),
                      device="cpu")
    model = tuner.init(state_dict=finetune_params_from_jax(p0, backbone))[
        "model"]
    tuner.backward(model, *(torch.as_tensor(x) for x in batch))
    return {k: p.grad for k, p in model.named_parameters()}


def _port_run(precision, batch, p0, backbone=TINY_SAM, **cfg):
    config = FineTuneConfig(num_classes=2, learning_rate=LR,
                            precision=precision, backbone_cfg=backbone,
                            **cfg)
    tuner = FineTuner(config, device="cpu")
    state = tuner.init(state_dict=finetune_params_from_jax(p0, backbone))
    losses = []
    for _ in range(STEPS):
        state, loss, logits = tuner.step(state, *batch)
        assert torch.isfinite(logits).all()
        losses.append(float(loss))
    return state["model"].state_dict(), losses


@pytest.fixture(scope="module", params=[
    dict(freeze_below=2, b=2), dict(accum_steps=2, b=4)],
    ids=["freeze_below", "accum_steps"])
def parity_runs(request):
    cfg = dict(request.param)
    batch = _batch(3, b=cfg.pop("b"))
    p0, p3, jax_losses, g0 = _jax_run("parity", batch, grads=True, **cfg)
    sd, port_losses = _port_run("parity", batch, p0, **cfg)
    grads = (finetune_params_from_jax(g0, TINY_SAM),
             _port_grads(batch, p0, **cfg))
    return cfg, p0, p3, jax_losses, sd, port_losses, grads


class TestAgainstJax:
    def test_parity_losses(self, parity_runs):
        _, _, _, jax_losses, _, port_losses, _ = parity_runs
        np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)

    def test_parity_parameters(self, parity_runs):
        cfg, p0, p3, _, sd, _, (g_jax, g_port) = parity_runs
        want = finetune_params_from_jax(p3, TINY_SAM)
        start = finetune_params_from_jax(p0, TINY_SAM)
        assert set(want) == set(sd)
        for name, w in want.items():
            got = sd[name]
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-4,
                                       err_msg=name)
            # the update itself, not only the weights: AdamW moves each
            # element by about LR a step, so this reads the optimizer
            moved_p = (got - start[name]).flatten()
            moved_j = (w - start[name]).flatten()
            frozen = name.startswith("backbone.blocks.") and \
                int(name.split(".")[2]) < cfg.get("freeze_below", 0)
            if not frozen:
                # elements whose gradient is rounding noise in JAX: the
                # port's is noise there too, and their updates are not
                # compared
                gj = g_jax[name].flatten().abs()
                gp = g_port[name].flatten().abs()
                noise = gj <= ROUNDING * gj.max()
                assert (gp[noise] <= 2 * ROUNDING * gp.max()).all(), name
                if name.endswith("attn.qkv.bias"):
                    k_third = torch.arange(gj.numel()) // (gj.numel() // 3)
                    assert torch.equal(noise, k_third == 1), name
                    assert (gp[noise] <= ROUNDING * gp.max()).all(), name
                moved_p, moved_j = moved_p[~noise], moved_j[~noise]
            if frozen:
                assert not moved_p.any() and not moved_j.any(), name
            else:
                assert moved_j.abs().max() > 0.5 * LR, name
                rel = (moved_p - moved_j).norm() / moved_j.norm()
                assert rel < 0.05, (name, float(rel))

    def test_fast_losses(self):
        batch = _batch(4)
        p0, _, jax_losses = _jax_run("fast", batch)
        _, port_losses = _port_run("fast", batch, p0)
        assert np.isfinite(port_losses).all()
        np.testing.assert_allclose(port_losses, jax_losses, rtol=5e-2)

    def test_parity_step_runs_k6_in_every_layer(self, monkeypatch):
        """Under ``parity`` each trainable layer, windowed or global, takes
        the generic path: one K6 call per layer and forward, none of the
        fused trainable Functions (JAX vit.py:307-318)."""
        calls = []
        monkeypatch.setattr(tvit, "flash_attention_trainable",
                            lambda *a, **k: calls.append(a[3] is not None)
                            or G.flash_attention_trainable(*a, **k))
        for name in ("window_attention_trainable",
                     "global_attention_trainable"):
            monkeypatch.setattr(tvit, name, None)
        tuner = FineTuner(FineTuneConfig(precision="parity",
                                         backbone_cfg=TINY_SAM),
                          device="cpu")
        state = tuner.init(seed=0)
        tuner.step(state, *_batch(8))
        assert calls == [True] * TINY_SAM.depth


@pytest.fixture(scope="module")
def dino_runs():
    """3 ``parity`` steps of a tiny DINOv2-shaped backbone, both sides."""
    batch = _batch(9, size=56, grid=4)
    p0, p3, jax_losses = _jax_run("parity", batch, backbone=JAX_TINY_DINO)
    sd, port_losses = _port_run("parity", batch, p0, backbone=TINY_DINO)
    return p3, jax_losses, sd, port_losses


class TestDinov2AgainstJax:
    def test_parity_losses(self, dino_runs):
        _, jax_losses, _, port_losses = dino_runs
        np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)

    def test_parity_parameters(self, dino_runs):
        p3, _, sd, _ = dino_runs
        want = finetune_params_from_jax(p3, TINY_DINO)
        assert set(want) == set(sd)
        assert "backbone.blocks.1.ls2.gamma" in sd
        for name, w in want.items():
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(),
                                       atol=1e-4, err_msg=name)

    def test_backbone_names_resolve_as_in_jax(self):
        for name in ("medsam", "dinov2_vitb14"):
            got = FineTuneConfig(backbone=name).resolve_backbone()
            want = JaxConfig(backbone=name).resolve_backbone()
            assert (got.name, got.width, got.depth, got.num_heads,
                    got.image_size, got.patch_size) == \
                (want.name, want.width, want.depth, want.num_heads,
                 want.image_size, want.patch_size)
        with pytest.raises(KeyError, match="unknown backbone"):
            FineTuneConfig(backbone="dinov3").resolve_backbone()


class TestPortOnly:
    @pytest.fixture(scope="class")
    def base(self):
        batch = _batch(5)
        cfg = FineTuneConfig(num_classes=2, learning_rate=3e-3,
                             precision="parity", backbone_cfg=TINY_SAM)
        tuner = FineTuner(cfg, device="cpu")
        state = tuner.init(seed=0)
        sd0 = {k: v.clone() for k, v in state["model"].state_dict().items()}
        state, loss, logits = tuner.step(state, *batch)
        return batch, cfg, sd0, float(loss), logits

    @pytest.mark.parametrize("remat", ["block", "mlp"])
    def test_remat_equals_no_remat(self, base, remat):
        batch, cfg, sd0, loss, logits = base
        tuner = FineTuner(dataclasses.replace(cfg, remat=remat),
                          device="cpu")
        state = tuner.init(state_dict=sd0)
        state, loss_r, logits_r = tuner.step(state, *batch)
        np.testing.assert_allclose(float(loss_r), loss, rtol=1e-6)
        torch.testing.assert_close(logits_r, logits, atol=1e-6, rtol=1e-6)

    def test_empty_mask_stays_finite(self, base):
        batch, cfg, sd0, _, _ = base
        images, mask, labels = batch
        tuner = FineTuner(cfg, device="cpu")
        state = tuner.init(state_dict=sd0)
        state, loss, logits = tuner.step(state, images, np.zeros_like(mask),
                                         labels)
        assert np.isfinite(float(loss)) and torch.isfinite(logits).all()

    def test_accum_steps_must_divide_batch(self, base):
        batch, cfg, sd0, _, _ = base
        tuner = FineTuner(dataclasses.replace(cfg, accum_steps=2),
                          device="cpu")
        state = tuner.init(state_dict=sd0)
        with pytest.raises(ValueError, match="divisible"):
            tuner.step(state, *(x[:1] for x in batch))

    def test_multi_device_raises(self):
        """ZeRO-1 and a mesh raise, naming the modules that have no port."""
        with pytest.raises(NotImplementedError,
                           match="zero1 is multi-device.*sharding.py"):
            FineTuner(FineTuneConfig(zero1=True), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="mesh is multi-device.*core/mesh.py"):
            FineTuner(FineTuneConfig(), mesh=object(), device="cpu")

    def test_parity_trainable_layer_on_a_gpu_tensor_raises(self,
                                                            monkeypatch):
        """fp32 trainable attention on a non-CPU tensor goes to the K6
        kernel (here stopped at the library load, as a failed build or
        refused launch would stop it) and never to a plain version."""
        def launch(*_, **__):
            raise RuntimeError("K6 launch reached")

        monkeypatch.setattr(G, "_load", launch)
        monkeypatch.setattr(G, "flash_attention_fwd_plain", None)
        model = ViTDense(TINY_SAM, policy=FineTuner(FineTuneConfig(
            precision="parity"), device="cpu").policy, trainable=True)
        attn = model.blocks[0].attn
        x = torch.zeros(1, 4, 4, TINY_SAM.width, device="meta")
        with pytest.raises(RuntimeError, match="K6 launch reached"):
            attn.to("meta")(x, model.policy)


GRID64 = dataclasses.replace(
    SAM_VIT_B, image_size=64, patch_size=1, width=128, depth=2, num_heads=2,
    window_size=8, global_indexes=(1,), neck_channels=16)


def test_trainable_global_branch_matches_plain_attention():
    """A grid of 64x64 tokens: block 1 is a global layer (4096 tokens,
    Kw = 64; under ``parity`` K6's plain versions), held to use_flash=False
    under torch autograd, gradients of every parameter to fp32 1e-4."""
    from vit_deep_radiomics_tpu_torch.core.precision import PARITY

    rng = np.random.default_rng(6)
    images = torch.from_numpy(
        rng.uniform(size=(1, 64, 64, 3)).astype(np.float32))
    mask = torch.zeros(1, 64, 64, dtype=torch.bool)
    mask[:, 20:40, 10:30] = True
    labels = torch.tensor([[0.0, 1.0]])
    grads = {}
    for use_flash in (True, False):
        model = FineTuneModel(GRID64, 2, PARITY, use_flash=use_flash)
        model.init_random(0)
        assert model.backbone.blocks[1].attn._fused_variant(64, 64) == \
            "global"
        logits = model(images, mask)
        loss = (logits * labels).sum() + (logits ** 2).sum()
        loss.backward()
        grads[use_flash] = {k: p.grad for k, p in model.named_parameters()}
    for name, want in grads[False].items():
        torch.testing.assert_close(grads[True][name], want, atol=1e-4,
                                   rtol=1e-4, msg=name)


class TestCli:
    @pytest.fixture(scope="class")
    def cohort(self, tmp_path_factory):
        """tests/test_cli.py:377's cohort."""
        from vit_deep_radiomics_tpu_torch.data import synthetic

        tmp = tmp_path_factory.mktemp("ft_cli")
        cohort = synthetic.synthetic_cohort(
            n_patients=2, seed=5, dataset="stanford",
            height=48, width=48, ct_slices=3, pet_slices=2)
        synthetic.write_isotropic_hdf5(cohort, tmp / "iso.hdf5",
                                       tmp / "iso.csv")
        return tmp

    def _argv(self, tmp):
        return ["-h5", str(tmp / "iso.hdf5"), "-df", str(tmp / "iso.csv"),
                "-s", str(tmp / "ckpt"), "--datasets", "stanford",
                "--epochs", "1", "--batch-size", "2",
                "--precision", "parity", "--image-size", "64",
                "--depth", "2", "--width", "128", "--num-heads", "2",
                "--window-size", "2"]

    def test_samples_match_jax(self, cohort):
        from vit_deep_radiomics_tpu.cli import finetune as jax_cli
        from vit_deep_radiomics_tpu_torch.cli import finetune as port_cli

        argv = self._argv(cohort)
        jcfg, jimg, jmask, jlab = jax_cli._load_samples(
            jax_cli.build_parser().parse_args(argv))
        pcfg, pimg, pmask, plab = port_cli._load_samples(
            port_cli.build_parser().parse_args(argv + ["--device", "cpu"]))
        assert (pcfg.image_size, pcfg.depth, pcfg.width) == \
            (jcfg.image_size, jcfg.depth, jcfg.width)
        np.testing.assert_allclose(pimg, jimg, atol=1e-5)
        np.testing.assert_array_equal(pmask, jmask)
        np.testing.assert_array_equal(plab, jlab)

    def test_cli_trains_and_writes_a_checkpoint(self, cohort):
        from vit_deep_radiomics_tpu_torch.cli import finetune as port_cli

        A.reset_launch_counts()
        assert port_cli.main(self._argv(cohort) + ["--device", "cpu"]) == 0
        ckpt = torch.load(cohort / "ckpt" / "model_epoch_0000.pt",
                          weights_only=True)
        assert ckpt["epoch"] == 0
        assert "head.weight" in ckpt["state_dict"]
        assert not any(A.LAUNCHES.values())

    def test_dinov2_backbone(self, cohort):
        """``--backbone dinov2_vits14``: the same samples as the JAX CLI
        (a 4x4 patch grid at 56 px), and a ``parity`` epoch on the CPU
        that writes DINOv2's torch.hub names."""
        from vit_deep_radiomics_tpu.cli import finetune as jax_cli
        from vit_deep_radiomics_tpu_torch.cli import finetune as port_cli

        argv = ["-h5", str(cohort / "iso.hdf5"), "-df",
                str(cohort / "iso.csv"), "-s", str(cohort / "ckpt_dino"),
                "--datasets", "stanford", "--epochs", "1", "--batch-size",
                "2", "--precision", "parity", "--backbone", "dinov2_vits14",
                "--image-size", "56", "--depth", "1", "--width", "128",
                "--num-heads", "2"]
        jcfg, jimg, jmask, jlab = jax_cli._load_samples(
            jax_cli.build_parser().parse_args(argv))
        pcfg, pimg, pmask, plab = port_cli._load_samples(
            port_cli.build_parser().parse_args(argv + ["--device", "cpu"]))
        assert (pcfg.name, pcfg.image_size, pcfg.patch_size) == \
            (jcfg.name, jcfg.image_size, jcfg.patch_size)
        assert pmask.shape[1:] == (4, 4)
        np.testing.assert_allclose(pimg, jimg, atol=1e-5)
        np.testing.assert_array_equal(pmask, jmask)
        np.testing.assert_array_equal(plab, jlab)
        assert port_cli.main(argv + ["--device", "cpu"]) == 0
        sd = torch.load(cohort / "ckpt_dino" / "model_epoch_0000.pt",
                        weights_only=True)["state_dict"]
        assert {"backbone.cls_token", "backbone.blocks.0.ls1.gamma",
                "backbone.blocks.0.mlp.fc1.weight",
                "backbone.norm.weight"} <= set(sd)

    def test_defaults_and_zero1(self, cohort):
        from vit_deep_radiomics_tpu_torch.cli import finetune as port_cli

        args = port_cli.build_parser().parse_args(["-h5", "a", "-df", "b"])
        assert (args.device, args.precision, args.remat) == \
            ("cuda", "fast", "none")
        with pytest.raises(NotImplementedError,
                           match="multi-device.*sharding.py"):
            port_cli.main(self._argv(cohort) + ["--zero1"])
