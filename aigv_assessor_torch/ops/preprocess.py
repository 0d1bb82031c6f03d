"""Device-side frame resize and normalization
(`aigv_assessor_tpu/ops/preprocess.py`).

The JAX `resize_normalize` resizes with `jax.image.resize(method="bicubic")`:
Keys' cubic kernel with a = -0.5, widened by the scale when it shrinks (an
anti-aliased resize), half-pixel centres, one [in, out] weight matrix per
resized axis (`jax._src.image.scale.compute_weight_mat`), applied by an
fp32 einsum. Its fp32 weights are not the exact function's: XLA fuses the
sample position (i + 0.5) / scale - 0.5 into one multiply-add, and the fp32
rounding of that position moves a weight by up to ~1e-5, so JAX's fp32
resize lands 1e-5 to 1e-4 from the exact bicubic (torch's
`F.interpolate(mode="bicubic", antialias=True)` in float64) on [0, 1]
values. `resize_weights` builds JAX's matrices as its compiled program
computes them, in fp32 with that multiply-add (and the kernel's polynomials
as multiply-adds), on the host; `resize_normalize` applies them in float64
on the frames' device and rounds once to fp32, so a card and the CPU give
the same result and both sit within 1e-6 of JAX's fp32 result on [0, 1]
values (`tests/test_torch_resize.py`). An axis already at the model's size
is not resized, as in JAX. Then the mean / std normalization in fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aigv_assessor_torch.data.constants import NORMALIZE_STATS


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """fp32 a * b + c rounded once (the product of two fp32 values is exact
    in float64)."""
    return _f32(torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(b, dtype=torch.float64)
                + torch.as_tensor(c, dtype=torch.float64))


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """fp32 [in_size, out_size] on the CPU: JAX's anti-aliased Keys cubic
    (a = -0.5) weight matrix for one axis, each column summing to 1."""
    inv_scale = 1.0 / (out_size / in_size)
    inv32 = _f32(torch.tensor(inv_scale, dtype=torch.float64))
    kernel_scale = _f32(torch.tensor(max(inv_scale, 1.0), dtype=torch.float64))
    sample = _fma(torch.arange(out_size, dtype=torch.float32) + 0.5, inv32, -0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    x = x * (1.0 / kernel_scale)
    near = _fma(_fma(1.5, x, -2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(-0.5, x, 2.5), x, -4.0), x, 2.0)
    w = torch.where(x >= 2.0, 0.0, torch.where(x >= 1.0, far, near))
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_normalize(
    frames: torch.Tensor,  # [..., H, W, 3] uint8
    size: int = 448,
    normalize_type: str = "imagenet",
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 frames of any size -> [..., size, size, 3] of (x/255 - mean) /
    std in `dtype`, resized as JAX's `jax.image.resize(method="bicubic")`."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")
    if frames.ndim < 3 or frames.shape[-1] != 3:
        raise ValueError(f"expected [..., H, W, 3] frames, got {tuple(frames.shape)}")
    h, w = frames.shape[-3:-1]
    if (h, w) == (size, size):
        x = frames.float() / 255.0
    else:
        x = frames.double() / 255.0
        if h != size:
            x = torch.einsum("...HWc,Hh->...hWc", x,
                             resize_weights(h, size).to(x.device, torch.float64))
        if w != size:
            x = torch.einsum("...hWc,Ww->...hwc", x,
                             resize_weights(w, size).to(x.device, torch.float64))
        x = x.float()
    mean, std = NORMALIZE_STATS[normalize_type]
    mean = torch.tensor(mean, dtype=torch.float32, device=frames.device)
    std = torch.tensor(std, dtype=torch.float32, device=frames.device)
    return ((x - mean) / std).to(dtype)
