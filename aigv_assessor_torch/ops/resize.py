"""Torch's bicubic resize of a position-embedding grid
(`aigv_assessor_tpu/ops/resize.py:59-74`).

The reference interpolates the ViT position embedding with
`F.interpolate(..., mode='bicubic', align_corners=False)` (Keys' cubic
kernel with A = -0.75, border taps clamped), which the JAX package rebuilds
as two constant interpolation matrices. Here it is that call itself, in
fp32. JAX computes it outside any Pallas kernel, so it has no kernel of its
own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bicubic_resize_grid(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, Hs, Ws, C] -> [B, h, w, C], torch's bicubic in fp32, cast back to
    the grid's dtype."""
    out = F.interpolate(grid.float().permute(0, 3, 1, 2), size=(h, w), mode="bicubic",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(grid.dtype)
