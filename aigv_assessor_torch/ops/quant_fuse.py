"""Fused producer + per-row int8 quantize (`aigv_assessor_tpu/ops/quant_fuse.py`):
CUDA kernel wrappers and plain versions.

The W8A8 ViT feeds its int8 projections through three of them, each one
read of the producer's input instead of the producer's write plus the
quantizer's passes:

- `layernorm_quant` (K4a): LayerNorm -> int8, the norm1/norm2 -> qkv/fc1 feeds;
- `gelu_quant` (K4b): tanh-GELU -> int8, the fc1 -> fc2 feed;
- `quant_rows` (K4c): identity -> int8, the attention output -> proj feed.

Each returns (q int8 [..., C], scale fp32 [..., 1]), what
`ops/w8a8.w8a8_matmul` takes as a pre-quantized input. On a CUDA tensor the
wrapper launches the kernel (`csrc/quant_fuse.cu`, built with nvcc at first
use) or raises; on a CPU tensor it runs its plain version, which follows the
JAX package's XLA fallback op for op. Each wrapper counts its kernel
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary
from aigv_assessor_torch.ops.w8a8 import Quantized, quantize_rows

_IDENTITY, _LAYERNORM, _GELU_TANH = 0, 1, 2  # the kernel's producers
MAX_COLS = 8192  # the kernel keeps a row of at most 8 x 1024 values in registers
_SQRT_2_OVER_PI = 0.7978845608028654


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_quant_rows_fwd.argtypes = [
        ctypes.c_int,  # producer
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, gamma, beta
        ctypes.c_float,  # eps
        ctypes.c_void_p, ctypes.c_void_p,  # q, scale
        ctypes.c_longlong, ctypes.c_int,  # rows, cols
        ctypes.c_void_p,  # stream
    ]
    lib.aigv_quant_rows_fwd.restype = ctypes.c_int


LIB = CudaLibrary("quant_fuse.cu", _declare)


# ---------------------------------------------------------------- plain ---


def plain_layernorm_quant(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> Quantized:
    """`_layernorm_quant_xla`: fp32 statistics with a two-pass variance."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return quantize_rows(y * weight.float() + bias.float())


def plain_gelu_quant(x: torch.Tensor) -> Quantized:
    """`_gelu_quant_xla`: tanh-GELU in fp32, with JAX's order of operations."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (xf + 0.044715 * xf * xf * xf)))
    return quantize_rows(y)


plain_quant_rows = quantize_rows  # the identity producer's plain version


# --------------------------------------------------------------- kernel ---


def _launch(producer: int, x: torch.Tensor, *norm: torch.Tensor, eps: float = 0.0) -> Quantized:
    if x.device.type != "cuda":
        raise ValueError(f"the quantize kernels run on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the quantize kernels take bf16, got {x.dtype}")
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    if rows == 0 or cols % 8 or cols > MAX_COLS:
        raise ValueError(
            f"the quantize kernels take rows of a multiple of 8 and at most {MAX_COLS} "
            f"values, got {tuple(x.shape)}"
        )
    # rows are read as 16-byte vectors
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    for t in norm:
        if (t.dtype != torch.bfloat16 or t.shape != (cols,) or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"norm weight and bias must be contiguous bf16 [{cols}] on {x.device}, "
                f"16-byte aligned, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    gamma, beta = (t.data_ptr() for t in norm) if norm else (None, None)
    lib = LIB.load()
    with torch.cuda.device(x.device):
        rc = lib.aigv_quant_rows_fwd(
            producer, x.data_ptr(), gamma, beta, eps, q.data_ptr(), s.data_ptr(),
            rows, cols, torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIB.check(rc, "quantize kernel")
    return q, s


def layernorm_quant(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> Quantized:
    """LayerNorm over the last dim (fp32 statistics), then per-row int8 (K4a)."""
    if x.device.type == "cpu":
        return plain_layernorm_quant(x, weight, bias, eps)
    out = _launch(_LAYERNORM, x, weight, bias, eps=eps)
    layernorm_quant.launches += 1
    return out


def gelu_quant(x: torch.Tensor) -> Quantized:
    """tanh-GELU, then per-row int8 (K4b)."""
    if x.device.type == "cpu":
        return plain_gelu_quant(x)
    out = _launch(_GELU_TANH, x)
    gelu_quant.launches += 1
    return out


def quant_rows(x: torch.Tensor) -> Quantized:
    """Per-row int8 in one read (K4c), for a producer that cannot quantize
    in its own epilogue: the attention kernel's output."""
    if x.device.type == "cpu":
        return plain_quant_rows(x)
    out = _launch(_IDENTITY, x)
    quant_rows.launches += 1
    return out


layernorm_quant.launches = 0
gelu_quant.launches = 0
quant_rows.launches = 0
