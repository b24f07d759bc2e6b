"""Port vs JAX: SAM-shaped ViTDense with weights bridged by params_from_jax.

A tiny SAM-shaped config (width 128, 2 heads of 64, patch 8, image 64,
window 4, one global layer, depth 3, 32-channel neck) with random rel-pos
tables, so that every bias path contributes. At this size every layer's
rel-pos grid has ≤1024 tokens, so the fused path runs window mode (K1)
only; global mode (K2) is covered in tests/test_torch_attention.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.core.precision import FAST as J_FAST
from vit_deep_radiomics_tpu.core.precision import PARITY as J_PARITY
from vit_deep_radiomics_tpu.models import vit as jvit
from vit_deep_radiomics_tpu_torch.core.precision import FAST, PARITY
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.models.convert import params_from_jax

TINY = dict(image_size=64, patch_size=8, width=128, depth=3, num_heads=2,
            window_size=4, global_indexes=(1,), neck_channels=32)
J_CFG = dataclasses.replace(jvit.SAM_VIT_B, **TINY)
T_CFG = dataclasses.replace(tvit.SAM_VIT_B, **TINY)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    params = jvit.ViTDense(J_CFG, policy=J_PARITY, use_flash=False).init(
        jax.random.PRNGKey(0), jnp.asarray(img))
    params = jax.tree_util.tree_map(np.array, params)
    for i in range(J_CFG.depth):
        attn = params["params"][f"block_{i}"]["attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            attn[name] = (rng.normal(size=attn[name].shape) * 0.5).astype(
                np.float32)
    with jax.default_matmul_precision("highest"):
        outs = {
            (pol.name, flash): np.asarray(
                jvit.ViTDense(J_CFG, policy=pol, use_flash=flash).apply(
                    params, jnp.asarray(img)), np.float32)
            for pol, flash in ((J_PARITY, False), (J_PARITY, True),
                               (J_FAST, True))
        }
    return img, params_from_jax(params, T_CFG), outs


def _port(setup, policy, use_flash):
    img, sd, _ = setup
    model = tvit.ViTDense(T_CFG, policy=policy, use_flash=use_flash)
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(img))
    assert out.dtype == torch.float32
    return out.numpy()


class TestParity:
    @pytest.mark.parametrize("use_flash", [False, True])
    @pytest.mark.parametrize("jax_flash", [False, True])
    def test_fp32_matches_jax(self, setup, use_flash, jax_flash):
        """fp32 parity at 2e-5 against both the JAX oracle
        (use_flash=False) and the JAX fused path (Pallas, interpret)."""
        got = _port(setup, PARITY, use_flash)
        want = setup[2][("parity", jax_flash)]
        assert got.shape == want.shape == (2, 8, 8, 32)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    def test_fast_matches_jax_fast(self, setup):
        """bf16 ``fast``: the port's gap to JAX fast is held to the gap
        JAX fast itself shows against the fp32 oracle. Measured on this
        config: port fast vs JAX fast 0.035 max abs, JAX fast vs oracle
        0.037, on outputs of max |x| 3.4; the bound is 2x the JAX gap and
        6e-2 absolute."""
        got = _port(setup, FAST, True)
        outs = setup[2]
        jax_gap = np.abs(outs[("fast", True)] - outs[("parity", False)]).max()
        port_gap = np.abs(got - outs[("fast", True)]).max()
        assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)
        np.testing.assert_allclose(got, outs[("fast", True)], atol=6e-2)

    def test_state_dict_names_are_reference_names(self, setup):
        """params_from_jax covers the port's state_dict exactly, under
        the reference PyTorch names."""
        sd = setup[1]
        model = tvit.ViTDense(T_CFG, policy=PARITY)
        assert set(sd) == set(model.state_dict())
        for key in ("patch_embed.proj.weight", "blocks.0.attn.qkv.weight",
                    "blocks.0.attn.rel_pos_h", "blocks.1.mlp.lin1.weight",
                    "neck.0.weight", "neck.3.bias"):
            assert key in sd
        assert tuple(sd["patch_embed.proj.weight"].shape) == (128, 3, 8, 8)


class TestFusedVariant:
    """The port selects the fused mode exactly as JAX vit.py:420-442."""

    @pytest.mark.parametrize("h,w,heads,width,expect", [
        (14, 14, 12, 768, "window"),    # SAM windowed layer
        (32, 32, 12, 768, "window"),    # 1024 tokens: still window
        (64, 64, 12, 768, "global"),    # SAM global layer
        (8, 8, 2, 128, "window"),       # tiny global layer → window
        (33, 33, 12, 768, None),        # 1089 tokens, no tile divides
        (14, 14, 3, 96, None),          # head layout does not tile
        (128, 128, 12, 768, "global"),  # SAM @2048 global layer (Kw 128)
        (48, 48, 12, 768, None),        # SAM @768 global layer
        (96, 96, 12, 768, None),        # SAM @1536 global layer
    ])
    def test_same_selection(self, h, w, heads, width, expect):
        j_cfg = dataclasses.replace(J_CFG, num_heads=heads, width=width)
        t_cfg = dataclasses.replace(T_CFG, num_heads=heads, width=width)
        j_attn = jvit.WindowedAttention(j_cfg, J_PARITY)
        t_attn = tvit.WindowedAttention(t_cfg, input_size=h)
        assert t_attn._fused_variant(h, w) == expect
        assert j_attn._fused_variant(h, w) == expect


class TestWindowPartition:
    @pytest.mark.parametrize("hw,window", [((8, 8), 4), ((10, 7), 4)])
    def test_partition_roundtrip_matches_jax(self, rng, hw, window):
        """Zero padding (64 → 70 at SAM scale) and window order as JAX."""
        x = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
        jp, jdims = jvit.window_partition(jnp.asarray(x), window)
        tp, tdims = tvit.window_partition(torch.from_numpy(x), window)
        assert tuple(jdims) == tuple(tdims)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        back = tvit.window_unpartition(tp, window, tdims)
        np.testing.assert_array_equal(back.numpy(), x)

    def test_sam_scale_window_count(self):
        x = torch.zeros(4, 64, 64, 1)
        parts, dims = tvit.window_partition(x, 14)
        assert parts.shape[0] == 100 and dims == (64, 64, 70, 70)
