"""Fused producer + per-row int8 quantize (`aigv_assessor_tpu/ops/quant_fuse.py`):
CUDA kernel wrappers and plain versions.

The W8A8 towers feed their int8 projections through them, each one read of
the producer's input instead of the producer's write plus the quantizer's
passes:

- `layernorm_quant` (K4a): LayerNorm -> int8, the ViT's norm1/norm2 -> qkv/fc1
  feeds;
- `gelu_quant` (K4b): tanh-GELU -> int8, the ViT's fc1 -> fc2 feed;
- `quant_rows` (K4c): identity -> int8, the attention output -> proj / wo feed;
- `rmsnorm_quant` (K5a): RMSNorm -> int8, the decoder's attention_norm /
  ffn_norm -> wqkv / w1+w3 feeds;
- `silu_mul_quant` (K5b): silu(h1) * h3 -> int8, the decoder's SwiGLU -> w2
  feed.

Which feeds a model fuses is `Precision.fuse_quant` / `Precision.quant_rows`.

Each returns (q int8 [..., C], scale fp32 [..., 1]), what
`ops/w8a8.w8a8_matmul` takes as a pre-quantized input. On a CUDA tensor the
wrapper launches the kernel (`csrc/quant_fuse.cu`, built with nvcc at first
use) or raises; on a CPU tensor it runs its plain version, which follows the
JAX package's XLA fallback op for op. Each wrapper counts its kernel
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary
from aigv_assessor_torch.ops.w8a8 import Quantized, quantize_rows

_IDENTITY, _LAYERNORM, _GELU_TANH, _RMSNORM, _SILU_MUL = 0, 1, 2, 3, 4  # the kernel's producers
MAX_COLS = 16384  # the kernel keeps a row of at most 8 x 2048 values in registers
_SQRT_2_OVER_PI = 0.7978845608028654


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_quant_rows_fwd.argtypes = [
        ctypes.c_int,  # producer
        ctypes.c_void_p, ctypes.c_void_p,  # x, x2
        ctypes.c_void_p, ctypes.c_void_p,  # gamma, beta
        ctypes.c_float,  # eps
        ctypes.c_void_p, ctypes.c_void_p,  # q, scale
        ctypes.c_longlong, ctypes.c_int,  # rows, cols
        ctypes.c_void_p,  # stream
    ]
    lib.aigv_quant_rows_fwd.restype = ctypes.c_int
    # the GELU producer alone (a measuring aid: tools/quant_fuse_ab.py)
    lib.aigv_gelu_values.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p]
    lib.aigv_gelu_values.restype = ctypes.c_int


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


def plain_rmsnorm_quant(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> Quantized:
    """`_rmsnorm_quant_xla`: the weight multiplies the fp32 normalized x."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return quantize_rows(y * weight.float())


def plain_silu_mul_quant(h1: torch.Tensor, h3: torch.Tensor) -> Quantized:
    """`_silu_mul_quant_xla`: silu(h1) * h3 in fp32, silu as h1 * sigmoid(h1)."""
    h1f = h1.float()
    return quantize_rows(h1f * torch.sigmoid(h1f) * h3.float())


plain_quant_rows = quantize_rows  # the identity producer's plain version


# --------------------------------------------------------------- kernel ---


def _check_operand(t: torch.Tensor, what: str, shape: tuple, device: torch.device) -> None:
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"{what} must be contiguous bf16 {list(shape)} on {device}, 16-byte aligned, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _launch(producer: int, x: torch.Tensor, *norm: torch.Tensor,
            x2: Optional[torch.Tensor] = None, eps: float = 0.0) -> Quantized:
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
        _check_operand(t, "norm weight and bias", (cols,), x.device)
    if x2 is not None:
        _check_operand(x2, "the second input", tuple(x.shape), x.device)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    gamma, beta = ([t.data_ptr() for t in norm] + [None, None])[:2]
    lib = LIB.load()
    with torch.cuda.device(x.device):
        rc = lib.aigv_quant_rows_fwd(
            producer, x.data_ptr(), None if x2 is None else x2.data_ptr(), gamma, beta, eps,
            q.data_ptr(), s.data_ptr(), rows, cols,
            torch.cuda.current_stream(x.device).cuda_stream,
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


def rmsnorm_quant(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> Quantized:
    """RMSNorm over the last dim (fp32, weight applied in fp32), then
    per-row int8 (K5a)."""
    if x.device.type == "cpu":
        return plain_rmsnorm_quant(x, weight, eps)
    out = _launch(_RMSNORM, x, weight, eps=eps)
    rmsnorm_quant.launches += 1
    return out


def silu_mul_quant(h1: torch.Tensor, h3: torch.Tensor) -> Quantized:
    """silu(h1) * h3 in fp32, then per-row int8 (K5b)."""
    if h1.device.type == "cpu":
        return plain_silu_mul_quant(h1, h3)
    out = _launch(_SILU_MUL, h1, x2=h3)
    silu_mul_quant.launches += 1
    return out


layernorm_quant.launches = 0
gelu_quant.launches = 0
quant_rows.launches = 0
rmsnorm_quant.launches = 0
silu_mul_quant.launches = 0
