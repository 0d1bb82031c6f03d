"""Device-side frame normalization (`aigv_assessor_tpu/ops/preprocess.py`).

The scoring path decodes frames at the model's input size, so the JAX
`resize_normalize` runs there with `size` equal to the frame size: an
identity resize. Only that case is ported. A real resize needs the JAX
package's bicubic kernel (Keys, a=-0.5), which is not torch's (a=-0.75),
and waits for its own port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from aigv_assessor_torch.data.constants import NORMALIZE_STATS


def resize_normalize(
    frames: torch.Tensor,  # [..., H, W, 3] uint8
    size: int = 448,
    normalize_type: str = "imagenet",
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 frames of `size` x `size` -> (x/255 - mean) / std in `dtype`."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")
    if frames.ndim < 3 or frames.shape[-1] != 3:
        raise ValueError(f"expected [..., H, W, 3] frames, got {tuple(frames.shape)}")
    h, w = frames.shape[-3:-1]
    if (h, w) != (size, size):
        raise NotImplementedError(
            f"frames are {h}x{w}, the model takes {size}x{size}: resizing on "
            "the device is not ported yet (ROADMAP.md, Queue 1); decode at "
            "the model's input size"
        )
    mean, std = NORMALIZE_STATS[normalize_type]
    mean = torch.tensor(mean, dtype=torch.float32, device=frames.device)
    std = torch.tensor(std, dtype=torch.float32, device=frames.device)
    x = frames.float() / 255.0
    return ((x - mean) / std).to(dtype)
