"""Torch's bicubic resize of a position-embedding grid
(`aigv_assessor_tpu/ops/resize.py:59-74`).

The reference interpolates the ViT position embedding with
`F.interpolate(..., mode='bicubic', align_corners=False)` (Keys' cubic
kernel with A = -0.75, border taps clamped), which the JAX package rebuilds
as two constant interpolation matrices. Here it is that call itself, in
fp32. JAX computes it outside any Pallas kernel, so it has no kernel of its
own.

`bicubic_matrix` is JAX's matrix of that kernel along one axis, its weights
rounded to fp32 as JAX rounds them; `tools/resize_pos_embed.py` applies it
in float64, as JAX's tool does, for the same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """ATen's `get_cubic_upsample_coefficients`: the 4 tap weights [..., 4]
    for a fractional offset t in [0, 1)."""
    def conv1(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def conv2(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return np.stack([conv2(t + 1.0), conv1(t), conv1(1.0 - t), conv2(2.0 - t)], axis=-1)


def bicubic_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """fp32 [dst, src] matrix of `F.interpolate(mode='bicubic',
    align_corners=False)` along one axis, border taps clamped
    (`aigv_assessor_tpu/ops/resize.py:41-57`)."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    d = np.arange(dst, dtype=np.float64)
    real = (src / dst) * (d + 0.5) - 0.5  # area_pixel_compute_source_index
    i0 = np.floor(real).astype(np.int64)
    w = _cubic_weights(real - i0, a)
    mat = np.zeros((dst, src), dtype=np.float64)
    for tap in range(4):
        np.add.at(mat, (np.arange(dst), np.clip(i0 - 1 + tap, 0, src - 1)), w[:, tap])
    return mat.astype(np.float32)


def bicubic_resize_grid(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, Hs, Ws, C] -> [B, h, w, C], torch's bicubic in fp32, cast back to
    the grid's dtype."""
    out = F.interpolate(grid.float().permute(0, 3, 1, 2), size=(h, w), mode="bicubic",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(grid.dtype)
