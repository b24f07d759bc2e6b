"""Port vs JAX: intensity preprocessing, the slice resize, the fused
resample, mask transforms and ROI geometry, on random volumes.

Masks and ROI boxes must be exactly equal; fp32 intensities agree to
1e-5. bf16 resample outputs are the fp32 result rounded once, so they
agree to one bf16 step (2^-8 on [0, 1]) at most.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_deep_radiomics_tpu.ops import preprocess as jpp
from vit_deep_radiomics_tpu.ops import roi as jroi
from vit_deep_radiomics_tpu.ops import sampling as jsm
from vit_deep_radiomics_tpu_torch.ops import preprocess as tpp
from vit_deep_radiomics_tpu_torch.ops import roi as troi
from vit_deep_radiomics_tpu_torch.ops import sampling as tsm

AUGS = [(f, a) for f in (None, "horizontal", "vertical")
        for a in (0, 45, 90, 135)]


class TestIntensity:
    def test_apply_window_ct(self, rng):
        hu = rng.normal(-300, 600, size=(20, 24, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tpp.apply_window_ct(torch.from_numpy(hu), 800, 40).numpy(),
            np.asarray(jpp.apply_window_ct(jnp.asarray(hu), 800, 40)),
            atol=1e-5, rtol=1e-5)

    def test_hu_to_rgb_exact(self, rng):
        """uint8 output, every band including the 40..80 HU quirk."""
        hu = np.concatenate([
            rng.uniform(-1200, 600, size=2000),
            np.array([-1000, -600, -400, -100, -60, 40, 60, 80, 400]),
        ]).astype(np.float32)
        got = tpp.hu_to_rgb(torch.from_numpy(hu))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpp.hu_to_rgb(jnp.asarray(hu))))

    def test_normalize_pet(self, rng):
        pet = np.abs(rng.normal(0.5, 0.3, size=(16, 16, 4))).astype(
            np.float32)
        np.testing.assert_allclose(
            tpp.normalize_pet(torch.from_numpy(pet)).numpy(),
            np.asarray(jpp.normalize_pet(jnp.asarray(pet))),
            atol=1e-5, rtol=1e-5)


class TestResize:
    """``resize_slices`` and ``prepare_vit_input`` against
    ``jax.image.resize(..., "linear")`` (half-pixel centres; antialiased
    when shrinking), to 1e-5: up and down, grayscale and RGB, an uneven
    ratio and a non-square slice."""

    @pytest.mark.parametrize("shape,out", [
        ((3, 24, 24), 32), ((2, 40, 40), 24), ((3, 33, 33), 20),
        ((2, 16, 16, 3), 50), ((2, 40, 40, 3), 24), ((2, 37, 37, 3), 14)])
    def test_prepare_vit_input(self, rng, shape, out):
        vol = rng.uniform(size=shape).astype(np.float32)
        want = np.asarray(jpp.prepare_vit_input(jnp.asarray(vol), out))
        got = tpp.prepare_vit_input(torch.from_numpy(vol), out)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("shape,out_hw", [
        ((2, 20, 30), (16, 16)), ((2, 12, 10, 3), (30, 24)),
        ((1, 30, 20, 3), (15, 40))])
    def test_resize_slices(self, rng, shape, out_hw):
        vol = rng.uniform(size=shape).astype(np.float32)
        want = np.asarray(jpp.resize_slices(jnp.asarray(vol), out_hw))
        got = tpp.resize_slices(torch.from_numpy(vol), out_hw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _jax_resample(vol, boxes, valid_hw, out, dtype, slice_batch):
    return np.asarray(jsm.resample_all_augmentations(
        jnp.asarray(vol), jnp.asarray(boxes, jnp.int32),
        jnp.asarray([a for _, a in AUGS], jnp.float32),
        jnp.asarray([f == "horizontal" for f, _ in AUGS]),
        jnp.asarray([f == "vertical" for f, _ in AUGS]),
        (jnp.int32(valid_hw[0]), jnp.int32(valid_hw[1])), out,
        out_dtype=dtype, slice_batch=slice_batch), np.float32)


class TestResample:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_all_augmentations_padded_volume(self, rng, dtype):
        """A (30, 26) volume zero-padded to (32, 32), 12 augmentations,
        3 slices in chunks of 5 (the last chunk repeats the last slice)."""
        vol = np.zeros((32, 32, 3), np.float32)
        vol[:30, :26] = rng.uniform(size=(30, 26, 3))
        boxes = [(int(rng.integers(0, 8)), int(rng.integers(0, 6)),
                  int(rng.integers(12, 22)), int(rng.integers(12, 20)))
                 for _ in AUGS]
        want = _jax_resample(vol, boxes, (30, 26), 24,
                             getattr(jnp, dtype), 5)
        got = tsm.resample_all_augmentations(
            torch.from_numpy(vol), boxes, [a for _, a in AUGS],
            [f == "horizontal" for f, _ in AUGS],
            [f == "vertical" for f, _ in AUGS], (30, 26), 24,
            out_dtype=getattr(torch, dtype), slice_batch=5)
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == want.shape == (8, 5, 24, 24, 3)
        atol = 1e-5 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                                   rtol=0)
        np.testing.assert_array_equal(got[-1, -1].float().numpy(),
                                      got[-1, 0].float().numpy())


class TestTransformMask:
    @pytest.mark.parametrize("flip,angle", AUGS)
    def test_masks_equal(self, rng, flip, angle):
        mask = np.zeros((40, 36, 3), np.float32)
        for k in range(3):
            cy, cx = rng.integers(8, 28), rng.integers(8, 26)
            r = rng.integers(2, 7)
            yy, xx = np.mgrid[:40, :36]
            mask[..., k] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        want = np.asarray(jsm.transform_mask(
            jnp.asarray(mask), jnp.float32(angle),
            jnp.bool_(flip == "horizontal"), jnp.bool_(flip == "vertical"),
            (jnp.int32(38), jnp.int32(36))))
        got = tsm.transform_mask(torch.from_numpy(mask), angle,
                                 flip == "horizontal", flip == "vertical",
                                 (38, 36))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


class TestRoiGeometry:
    @pytest.fixture
    def masks(self, rng):
        out = []
        for _ in range(12):
            m = np.zeros((48, 40), bool)
            y0, x0 = rng.integers(0, 44), rng.integers(0, 36)
            m[y0:y0 + rng.integers(1, 10), x0:x0 + rng.integers(1, 10)] = True
            out.append(m)
        return out

    def test_boxes_equal(self, masks):
        for m in masks:
            for margin in (1, 2):
                assert troi.extract_coords(m, margin) == \
                    jroi.extract_coords(m, margin)
            assert troi.square_crop_box(m) == jroi.square_crop_box(m)
            for shape in ((48, 40), (8, 8), (64, 64)):
                assert troi.scaled_roi_box(shape, m) == \
                    jroi.scaled_roi_box(shape, m)

    def test_crops_equal(self, rng, masks):
        feat = rng.normal(size=(8, 8, 4)).astype(np.float32)
        img = rng.normal(size=(48, 40)).astype(np.float32)
        for m in masks:
            np.testing.assert_array_equal(troi.extract_roi(feat, m),
                                          jroi.extract_roi(feat, m))
            box = troi.square_crop_box(m)
            np.testing.assert_array_equal(troi.crop_image(img, *box),
                                          jroi.crop_image(img, *box))
