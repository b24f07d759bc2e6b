"""3D sin/cos positional encoding for voxel token sequences.

Counterpart of ``vit_deep_radiomics_tpu/ops/posenc.py``: D//6 frequency
bands; for band i, channels (2i, 2i+1) carry sin/cos of x / scale^(6i/D),
with the y and z copies offset by D//3 and 2·D//3. Channels no band covers
(84, 169, 254, 255 for D=256) stay zero. Everything in fp32, on the
coordinates' device.
"""

from __future__ import annotations

import torch

__all__ = ["positional_encoding_3d"]


def positional_encoding_3d(x, y, z, d: int, scale: float = 10000.0):
    """Encode (N,) voxel coordinates (mm) into (N, d) sin/cos features
    (any leading shape: the encoding is a new last axis)."""
    x, y, z = (torch.as_tensor(c, dtype=torch.float32) for c in (x, y, z))
    n_bands = d // 6
    third = d // 3
    i = torch.arange(n_bands, dtype=torch.float32, device=x.device)
    inv_freq = torch.pow(torch.tensor(scale, dtype=torch.float32,
                                      device=x.device), -6.0 * i / d)
    out = torch.zeros(x.shape + (d,), dtype=torch.float32, device=x.device)
    idx = torch.arange(n_bands, device=x.device) * 2
    for offset, coord in ((0, x), (third, y), (2 * third, z)):
        phase = coord[..., None] * inv_freq
        out[..., idx + offset] = torch.sin(phase)
        out[..., idx + 1 + offset] = torch.cos(phase)
    return out
