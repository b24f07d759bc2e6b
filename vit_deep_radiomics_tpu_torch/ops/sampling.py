"""Fused flip → rotate → crop → resize as one bilinear gather, in PyTorch.

Counterpart of ``vit_deep_radiomics_tpu/ops/sampling.py`` (XLA gathers
there, plain tensor indexing here). The four steps compose into one
inverse affine map from output pixels to source coordinates:

1. resize⁻¹ with half-pixel centers, clamped to the crop interior,
2. rotate⁻¹ about the valid area's center (scipy's direction),
3. flip⁻¹ (the reference flips before rotating),
4. edge clamp ('nearest' boundary).

The arithmetic keeps the JAX order of float32 operations, so masks
re-binarised with ``> 0`` come out identical.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "fused_flip_rotate_crop_resize",
    "resample_all_augmentations",
    "transform_mask",
]

_DEG2RAD = torch.tensor(math.pi / 180.0, dtype=torch.float32).item()


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _source_coords(out_h, out_w, box, angle_deg, flip_h, flip_v, height,
                   width, device):
    """(out_h, out_w) source row/column fields for one augmentation."""
    ymin, xmin, crop_h, crop_w = (_f32(v, device) for v in box)
    h, w = _f32(height, device), _f32(width, device)
    i = torch.arange(out_h, dtype=torch.float32, device=device)
    j = torch.arange(out_w, dtype=torch.float32, device=device)
    yc = ymin + torch.clamp((i + 0.5) * crop_h / out_h - 0.5, min=0.0) \
        .minimum(crop_h - 1.0)
    xc = xmin + torch.clamp((j + 0.5) * crop_w / out_w - 0.5, min=0.0) \
        .minimum(crop_w - 1.0)
    yy = yc[:, None].expand(out_h, out_w)
    xx = xc[None, :].expand(out_h, out_w)

    # cos/sin on the CPU, whatever the device: a GPU's cosf may differ in
    # the last bit, and that can move a re-binarised mask pixel
    theta = _f32(angle_deg, "cpu") * _DEG2RAD
    cos_t = torch.cos(theta).to(device)
    sin_t = torch.sin(theta).to(device)
    cy, cx = (h - 1.0) / 2.0, (w - 1.0) / 2.0
    yr = yy - cy
    xr = xx - cx
    ys = cos_t * yr + sin_t * xr + cy
    xs = -sin_t * yr + cos_t * xr + cx

    if flip_v:
        ys = h - 1.0 - ys
    if flip_h:
        xs = w - 1.0 - xs
    ys = torch.clamp(ys, min=0.0).minimum(h - 1.0)
    xs = torch.clamp(xs, min=0.0).minimum(w - 1.0)
    return ys, xs


def _gather_bilinear_planes(planes, ys, xs, hmax, wmax, width):
    """Bilinear-sample every plane: ``planes`` (P, H·W) flattened slices,
    ``ys``/``xs`` (out_h, out_w) source fields → (P, out_h, out_w)."""
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, hmax)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, wmax)
    y1 = torch.clamp(y0 + 1, 0, hmax)
    x1 = torch.clamp(x0 + 1, 0, wmax)
    wy = (ys - y0.float()).reshape(-1)
    wx = (xs - x0.float()).reshape(-1)
    v00 = planes[:, (y0 * width + x0).reshape(-1)]
    v01 = planes[:, (y0 * width + x1).reshape(-1)]
    v10 = planes[:, (y1 * width + x0).reshape(-1)]
    v11 = planes[:, (y1 * width + x1).reshape(-1)]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape((planes.shape[0],) + tuple(ys.shape))


def fused_flip_rotate_crop_resize(volume, box, angle_deg, flip_h, flip_v,
                                  valid_hw, out_size: int,
                                  out_dtype=torch.float32):
    """(H, W, S) or (H, W, S, C) normalised volume → (S, out, out[, C])
    resampled slices clipped to [0, 1]; computed in fp32 and rounded once
    to ``out_dtype``."""
    ys, xs = _source_coords(out_size, out_size, box, angle_deg, flip_h,
                            flip_v, valid_hw[0], valid_hw[1], volume.device)
    h, w = volume.shape[:2]
    rest = tuple(volume.shape[2:])                  # (S,) or (S, C)
    planes = volume.float().reshape(h * w, -1).t()  # (S·C, H·W)
    out = _gather_bilinear_planes(planes, ys, xs, h - 1, w - 1, w)
    out = out.reshape(rest + (out_size, out_size))
    if len(rest) == 2:
        out = out.permute(0, 2, 3, 1)
    return torch.clamp(out, 0.0, 1.0).to(out_dtype)


def resample_all_augmentations(volume, boxes, angles, flips_h, flips_v,
                               valid_hw, out_size: int,
                               out_dtype=torch.float32,
                               slice_batch: int | None = None):
    """Every augmentation's resample → ``(A·S, out, out, 3)`` RGB slices
    (a grayscale (H, W, S) volume broadcast to RGB, an (H, W, S, 3) one as
    it is), or with ``slice_batch`` ``(ceil(A·S/slice_batch), slice_batch,
    out, out, 3)``, the last chunk padded by repeating the last slice.

    ``boxes`` are (ymin, xmin, crop_h, crop_w) per augmentation; angles and
    flips are host sequences."""
    out = torch.stack([
        fused_flip_rotate_crop_resize(volume, box, a, fh, fv, valid_hw,
                                      out_size, out_dtype)
        for box, a, fh, fv in zip(boxes, angles, flips_h, flips_v)
    ])                                                  # (A, S, o, o[, 3])
    if out.ndim == 4:
        out = out[..., None].expand(*out.shape, 3)
    out = out.reshape((-1, out_size, out_size, 3))
    if slice_batch is not None:
        n = out.shape[0]
        nchunks = -(-n // slice_batch)
        pad = nchunks * slice_batch - n
        if pad:
            out = torch.cat([out, out[-1:].expand(pad, *out.shape[1:])])
        out = out.reshape((nchunks, slice_batch) + tuple(out.shape[1:]))
    return out


def transform_mask(mask, angle_deg, flip_h, flip_v, valid_hw):
    """Flip + rotate an (H, W, S) mask in place (identity crop/resize),
    re-binarised with ``> 0``."""
    h, w = mask.shape[0], mask.shape[1]
    ys, xs = _source_coords(h, w, (0, 0, h, w), angle_deg, flip_h, flip_v,
                            valid_hw[0], valid_hw[1], mask.device)
    planes = mask.float().reshape(h * w, -1).t()
    out = _gather_bilinear_planes(planes, ys, xs, h - 1, w - 1, w)
    return torch.movedim(out, 0, 2) > 0
