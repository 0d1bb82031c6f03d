"""SlowFast-R50 motion branch (`aigv_assessor_tpu/models/motion.py`),
inference only.

Stems, four residual stages with fast-to-slow lateral fusion, and the head
pooling, with frozen (inference-mode) batch norm. The public layout is the
JAX package's, frames [B, T, H, W, 3]; inside, convolutions run on
PyTorch's NCDHW layout (cuDNN; the JAX package leaves them to XLA too).

- The slow pathway takes `linspace(0, T-1, T//alpha)` frames, truncated to
  int: for 8 frames, frames 0 and 7.
- The head repeats each time step `alpha` times, average-pools with stride
  1 over a (8, 7, 7) / (32, 7, 7) window in fp32, then takes the mean.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import MotionConfig


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics: x * inv + (bias - mean * inv),
    inv = scale / sqrt(var + eps), per channel of an NCDHW tensor."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        shift = self.bias - self.mean * inv
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class ConvBN(nn.Module):
    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: Tuple[int, int, int],
        strides: Tuple[int, int, int] = (1, 1, 1),
        use_relu: bool = True,
    ):
        super().__init__()
        self.conv = nn.Conv3d(
            in_features, features, kernel, stride=strides,
            padding=tuple(k // 2 for k in kernel), bias=False,
        )
        self.bn = FrozenBatchNorm(features)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x


class Bottleneck(nn.Module):
    """(t,1,1) conv_a, (1,3,3) conv_b carrying the spatial stride, (1,1,1)
    conv_c; a projection shortcut where the width or the stride changes."""

    def __init__(self, dim_in: int, dim_inner: int, dim_out: int,
                 temporal_kernel: int = 1, spatial_stride: int = 1):
        super().__init__()
        s = spatial_stride
        self.conv_a = ConvBN(dim_in, dim_inner, (temporal_kernel, 1, 1))
        self.conv_b = ConvBN(dim_inner, dim_inner, (1, 3, 3), strides=(1, s, s))
        self.conv_c = ConvBN(dim_inner, dim_out, (1, 1, 1), use_relu=False)
        self.shortcut = (
            ConvBN(dim_in, dim_out, (1, 1, 1), strides=(1, s, s), use_relu=False)
            if dim_in != dim_out or s != 1
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branch = self.conv_c(self.conv_b(self.conv_a(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + branch)


def res_stage(depth: int, dim_in: int, dim_inner: int, dim_out: int,
              temporal_kernel: int, spatial_stride: int) -> nn.Sequential:
    return nn.Sequential(OrderedDict(
        (f"block_{i}", Bottleneck(
            dim_in if i == 0 else dim_out, dim_inner, dim_out, temporal_kernel,
            spatial_stride if i == 0 else 1,
        ))
        for i in range(depth)
    ))


class PathwayStem(nn.Module):
    def __init__(self, features: int, temporal_kernel: int):
        super().__init__()
        self.conv = ConvBN(3, features, (temporal_kernel, 7, 7), strides=(1, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(self.conv(x), (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))


class FuseFastToSlow(nn.Module):
    """Temporal-strided conv on the fast pathway, concatenated onto the slow
    pathway's channels."""

    def __init__(self, fast_features: int, alpha: int, fusion_kernel: int, ratio: int):
        super().__init__()
        self.conv = ConvBN(
            fast_features, fast_features * ratio, (fusion_kernel, 1, 1),
            strides=(alpha, 1, 1),
        )

    def forward(self, slow: torch.Tensor, fast: torch.Tensor):
        return torch.cat([slow, self.conv(fast)], dim=1), fast


def pack_pathways(frames: torch.Tensor, alpha: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames [B, T, ...] -> (slow [B, T//alpha, ...], fast = frames)."""
    t = frames.shape[1]
    n_slow = max(1, t // alpha)
    idx = np.linspace(0, t - 1, n_slow).astype(np.int64)
    return frames[:, torch.from_numpy(idx).to(frames.device)], frames


class SlowFastR50(nn.Module):
    def __init__(self, config: MotionConfig = MotionConfig()):
        super().__init__()
        self.config = config
        sw, fw, r = config.slow_width, config.fast_width, config.fusion_conv_ratio
        fuse = dict(alpha=config.alpha, fusion_kernel=config.fusion_kernel, ratio=r)
        self.slow_stem = PathwayStem(sw, 1)
        self.fast_stem = PathwayStem(fw, 5)
        self.fuse_stem = FuseFastToSlow(fw, **fuse)
        slow_in, fast_in = sw + fw * r, fw
        depths = config.stage_depths
        # (slow_inner, slow_out, fast_inner, fast_out, slow_temporal_kernel, stride)
        specs = [
            (sw, sw * 4, fw, fw * 4, 1, 1),
            (sw * 2, sw * 8, fw * 2, fw * 8, 1, 2),
            (sw * 4, sw * 16, fw * 4, fw * 16, 3, 2),
            (sw * 8, sw * 32, fw * 8, fw * 32, 3, 2),
        ]
        for si, (s_inner, s_out, f_inner, f_out, s_tk, stride) in enumerate(specs):
            self.add_module(f"slow_res{si + 2}", res_stage(
                depths[si], slow_in, s_inner, s_out, s_tk, stride))
            self.add_module(f"fast_res{si + 2}", res_stage(
                depths[si], fast_in, f_inner, f_out, 3, stride))
            slow_in, fast_in = s_out, f_out
            if si < 3:  # no fusion after the last stage
                self.add_module(f"fuse_res{si + 2}", FuseFastToSlow(f_out, **fuse))
                slow_in += f_out * r

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, T, H, W, 3] normalized pixels -> [B, feature_dim]."""
        cfg = self.config
        dtype = self.slow_stem.conv.conv.weight.dtype
        slow, fast = (
            p.to(dtype).permute(0, 4, 1, 2, 3)  # -> NCDHW
            for p in pack_pathways(frames, cfg.alpha)
        )
        slow = self.slow_stem(slow)
        fast = self.fast_stem(fast)
        slow, fast = self.fuse_stem(slow, fast)
        for si in range(4):
            slow = getattr(self, f"slow_res{si + 2}")(slow)
            fast = getattr(self, f"fast_res{si + 2}")(fast)
            if si < 3:
                slow, fast = getattr(self, f"fuse_res{si + 2}")(slow, fast)

        feats = []
        for x, t_win in ((slow, 8), (fast, 32)):
            x = x.repeat_interleave(cfg.alpha, dim=2).float()
            win = (min(t_win, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
            feats.append(F.avg_pool3d(x, win, stride=1).mean(dim=(2, 3, 4)))
        return torch.cat(feats, dim=-1).to(dtype)  # [B, 32*sw + 32*fw]
