"""RMSNorm and LayerNorm with fp32 statistics, as functions and modules
(`aigv_assessor_tpu/ops/norms.py`); both return x's dtype."""

from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance over the last dim in fp32, no mean subtraction; the weight is
    applied after the cast back to the input dtype (InternLM2's order)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight.to(x.dtype) * xf.to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm in fp32 (statistics, weight and bias), cast back at the end."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics (`ops/norms.layer_norm`)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics (`ops/norms.rms_norm`)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
