"""Pixel shuffle of ViT tokens (`aigv_assessor_tpu/ops/pixel_shuffle.py`):
with scale 0.5 each 2x2 block of patch tokens folds into channels."""

from __future__ import annotations

import torch


def pixel_shuffle(
    x: torch.Tensor, scale_factor: float = 0.5, ps_version: str = "v2"
) -> torch.Tensor:
    """x: [N, W, H, C] -> [N, H*s, W*s, C/s^2] (v2 swaps H and W back).

    Follows the reference's view/permute sequence exactly, so that the
    channel order matches converted checkpoints."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale_factor), int(c / scale_factor))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(
        n, int(h * scale_factor), int(w * scale_factor), int(c / (scale_factor**2))
    )
    if ps_version != "v1":
        x = x.permute(0, 2, 1, 3)
    return x
