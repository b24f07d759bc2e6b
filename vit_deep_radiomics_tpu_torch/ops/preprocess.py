"""On-device CT/PET intensity preprocessing in PyTorch.

Counterpart of ``vit_deep_radiomics_tpu/ops/preprocess.py``: HU windowing,
the HU→RGB tissue transfer function (with the reference's 40..80 HU band
quirk), PET max-normalisation and the slice resize to the backbone input
(``jax.image.resize``'s ``linear``: half-pixel centres, the triangle
kernel widened when the image shrinks), as plain tensor code on the
input's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["windowing_ct", "apply_window_ct", "hu_to_rgb", "normalize_pet",
           "resize_slices", "prepare_vit_input"]


def windowing_ct(width: float, level: float) -> tuple[float, float]:
    """HU window (width, level) → (lower, upper) bounds."""
    return level - width / 2.0, level + width / 2.0


def apply_window_ct(ct: torch.Tensor, width: float, level: float):
    """Clip-normalise a CT volume to [0, 1] with an HU window."""
    lower, upper = windowing_ct(width, level)
    return torch.clamp((ct - lower) / (upper - lower), 0.0, 1.0)


_AIR = (0.0, 0.0, 0.0)
_LUNG = (194.0, 105.0, 82.0)
_FAT = (194.0, 166.0, 115.0)
_SOFT_LO = (102.0, 0.0, 0.0)
_SOFT_HI = (153.0, 0.0, 0.0)
_BONE = (255.0, 255.0, 255.0)


def _lerp(c0, c1, hu, lo, hi):
    r = ((hu - lo) / (hi - lo))[..., None]
    c0 = torch.tensor(c0, dtype=torch.float32, device=hu.device)
    c1 = torch.tensor(c1, dtype=torch.float32, device=hu.device)
    return c0 * (1.0 - r) + c1 * r


def hu_to_rgb(hu: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear HU→RGB tissue colouring, uint8 output, with the
    reference's float→int truncation. The 40..80 HU band interpolates with
    the 80..400 denominators, as the reference does."""
    hu = hu.float()
    rgb = torch.zeros(hu.shape + (3,), dtype=torch.float32, device=hu.device)

    def band(rgb, mask, value):
        value = torch.as_tensor(value, dtype=torch.float32, device=hu.device)
        return torch.where(mask[..., None], value, rgb)

    rgb = band(rgb, hu <= -1000, _AIR)
    rgb = band(rgb, (hu > -1000) & (hu < -600),
               _lerp(_AIR, _LUNG, hu, -1000, -600))
    rgb = band(rgb, (hu >= -600) & (hu <= -400), _LUNG)
    rgb = band(rgb, (hu > -400) & (hu < -100),
               _lerp(_LUNG, _FAT, hu, -400, -100))
    rgb = band(rgb, (hu >= -100) & (hu <= -60), _FAT)
    rgb = band(rgb, (hu > -60) & (hu < 40),
               _lerp(_FAT, _SOFT_LO, hu, -60, 40))
    rgb = band(rgb, (hu >= 40) & (hu <= 80),
               _lerp(_SOFT_LO, _SOFT_HI, hu, 80, 400))   # reference quirk
    rgb = band(rgb, (hu > 80) & (hu < 400),
               _lerp(_SOFT_HI, _BONE, hu, 80, 400))
    rgb = band(rgb, hu >= 400, _BONE)
    return torch.trunc(rgb).to(torch.uint8)


def normalize_pet(pet: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """PET → [0, 1] by the global max."""
    return pet / (torch.max(pet) + eps)


def resize_slices(vol: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize a (S, H, W, C) or (S, H, W) stack of slices in-plane, as
    ``jax.image.resize(..., "linear")`` does: half-pixel centres, and when
    an axis shrinks the triangle kernel widened by the scale (antialias),
    its weights renormalised at the borders. That is ``F.interpolate``'s
    bilinear with ``align_corners=False`` and, when shrinking,
    ``antialias=True``."""
    squeeze = vol.ndim == 3
    x = vol[..., None] if squeeze else vol
    h, w = x.shape[1:3]
    shrink = out_hw[0] < h or out_hw[1] < w
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                        mode="bilinear", align_corners=False,
                        antialias=shrink).permute(0, 2, 3, 1)
    return out[..., 0] if squeeze else out


def prepare_vit_input(vol: torch.Tensor, image_size: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(S, H, W) grayscale or (S, H, W, 3) RGB slices → the backbone input
    (S, image_size, image_size, 3). A grayscale stack is resized once and
    then repeated over the three channels (JAX repeats first: the same
    values, a third of the work)."""
    gray = vol.ndim == 3
    out = resize_slices(vol.float(), (image_size, image_size))
    if gray:
        out = out[..., None].expand(*out.shape, 3)
    return out.to(dtype).contiguous()
