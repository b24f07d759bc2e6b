"""Port vs JAX: backbone fine-tuning (engine/finetune.py, cli/finetune.py).

The JAX ``FineTuner`` on tests/test_finetune.py's ``TINY_SAM`` (its
``parity`` path runs the generic trainable kernels in interpret mode, its
``fast`` path the fused window kernels) and the port's ``FineTuner`` on the
CPU (the plain versions of K1, K4 and K5) start from the same weights,
bridged by ``models/convert.py::finetune_params_from_jax`` with the
rel-pos tables filled randomly so that the bias gradients count, and see
the same batches. ``parity``: the loss of every step to 1e-4 relative and
every parameter after 3 steps to 1e-4; ``fast``: the loss to 5e-2
relative (both sides round to bf16 at other places).
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
from vit_deep_radiomics_tpu.models.vit import SAM_VIT_B as JAX_SAM_VIT_B
from vit_deep_radiomics_tpu_torch.engine.finetune import (
    FineTuneConfig,
    FineTuneModel,
    FineTuner,
)
from vit_deep_radiomics_tpu_torch.models.convert import (
    finetune_params_from_jax,
)
from vit_deep_radiomics_tpu_torch.models.vit import SAM_VIT_B, ViTDense
from vit_deep_radiomics_tpu_torch.ops import attention as A

TINY = dict(image_size=64, width=128, depth=3, num_heads=2, window_size=4,
            global_indexes=(1,), neck_channels=32)
TINY_SAM = dataclasses.replace(SAM_VIT_B, **TINY)
JAX_TINY_SAM = dataclasses.replace(JAX_SAM_VIT_B, **TINY)
STEPS = 3
LR = 1e-5


def _batch(seed, b=2, size=64, grid=4):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, size, size, 3)).astype(np.float32)
    mask = np.zeros((b, grid, grid), bool)
    mask[:, 1:3, 1:3] = True
    labels = np.eye(2, dtype=np.float32)[np.arange(b) % 2]
    return images, mask, labels


def _jax_run(precision, batch, **cfg):
    """JAX FineTuner: (initial params, final params, per-step losses)."""
    config = JaxConfig(num_classes=2, learning_rate=LR, precision=precision,
                       backbone_cfg=JAX_TINY_SAM, **cfg)
    tuner = JaxTuner(config)
    params = tuner.init(jax.random.PRNGKey(0), jnp.asarray(batch[0]))[
        "params"]
    rng = np.random.default_rng(11)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "rel_pos" in name:
            return jnp.asarray(rng.normal(size=leaf.shape).astype(
                np.float32) * 0.2)
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    state = {"params": params,
             "opt_state": tuner._optimizer(params).init(params)}
    losses = []
    for _ in range(STEPS):
        state, loss, _ = tuner.step(state, *batch)
        losses.append(float(loss))
    return p0, jax.tree_util.tree_map(np.asarray, state["params"]), losses


def _port_run(precision, batch, p0, **cfg):
    config = FineTuneConfig(num_classes=2, learning_rate=LR,
                            precision=precision, backbone_cfg=TINY_SAM,
                            **cfg)
    tuner = FineTuner(config, device="cpu")
    state = tuner.init(state_dict=finetune_params_from_jax(p0, TINY_SAM))
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
    p0, p3, jax_losses = _jax_run("parity", batch, **cfg)
    sd, port_losses = _port_run("parity", batch, p0, **cfg)
    return cfg, p0, p3, jax_losses, sd, port_losses


class TestAgainstJax:
    def test_parity_losses(self, parity_runs):
        _, _, _, jax_losses, _, port_losses = parity_runs
        np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)

    def test_parity_parameters(self, parity_runs):
        cfg, p0, p3, _, sd, _ = parity_runs
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
        with pytest.raises(NotImplementedError, match="item 10"):
            FineTuner(FineTuneConfig(zero1=True), device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            FineTuner(FineTuneConfig(), mesh=object(), device="cpu")

    def test_parity_trainable_layer_on_a_gpu_tensor_raises(self):
        """The model refuses fp32 trainable attention on a non-CPU tensor
        (no K6 yet) instead of taking another path."""
        model = ViTDense(TINY_SAM, policy=FineTuner(FineTuneConfig(
            precision="parity"), device="cpu").policy, trainable=True)
        attn = model.blocks[0].attn
        x = torch.zeros(1, 4, 4, TINY_SAM.width, device="meta")
        with pytest.raises(NotImplementedError, match="K6"):
            attn.to("meta")(x, model.policy)


GRID64 = dataclasses.replace(
    SAM_VIT_B, image_size=64, patch_size=1, width=128, depth=2, num_heads=2,
    window_size=8, global_indexes=(1,), neck_channels=16)


def test_trainable_global_branch_matches_plain_attention():
    """A grid of 64x64 tokens: block 1 takes the trainable global branch
    (K5's plain versions), held to use_flash=False under torch autograd,
    gradients of every parameter to fp32 1e-4."""
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

    def test_defaults_and_zero1(self, cohort):
        from vit_deep_radiomics_tpu_torch.cli import finetune as port_cli

        args = port_cli.build_parser().parse_args(["-h5", "a", "-df", "b"])
        assert (args.device, args.precision, args.remat) == \
            ("cuda", "fast", "none")
        with pytest.raises(NotImplementedError, match="item 10"):
            port_cli.main(self._argv(cohort) + ["--zero1"])
