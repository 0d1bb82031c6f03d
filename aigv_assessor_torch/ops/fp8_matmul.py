"""fp8 (e4m3) weight-streaming matmul for decode
(`benchmarks/fp8_decode_probe.py:40-93`): a bf16 activation against an
e4m3 weight that is cast inside the kernel, never into device memory.

    y = (x @ float(w8)^T) * scale

The weight is cast to the activation dtype (exact: every e4m3 value is a
bf16 value), the sum runs in fp32, the fp32 per-channel scale is applied to
the fp32 sum, and the result is rounded to the output dtype once: the order
of the probe's `_fp8_kernel`.

Storage. The probe's leaf is [K, N]; the port stores the weight one row per
output channel, `w8` [N, K] `torch.float8_e4m3fn`, as `ops/int8_matmul.py`
does for int8 and int4, so that a channel's K bytes are contiguous.

- `quantize_weight_fp8`: [N, K] float -> (e4m3 [N, K], fp32 [N]), the
  probe's per-output-channel absmax / 448 on the transposed array.
- `plain_fp8_matmul`: the plain PyTorch version.
- `fp8_matmul`: the kernel's wrapper (`csrc/fp8_matmul.cu`, built with nvcc
  at first use and loaded with ctypes). On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs the plain version. It counts its
  launches in `.launches`. Any M, N and K: the kernel handles the edges, the
  wrapper pads nothing.
- `fp8_dense_apply`: any leading dims.

Nothing in the models serves fp8 weights, as nothing in the JAX package
does: the probe (`tools/fp8_decode_probe.py`) is the kernel's one caller.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary

E4M3_MAX = 448.0  # the largest finite float8_e4m3fn value
E4M3 = torch.float8_e4m3fn


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_fp8_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w8, scale, y
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, N, K
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # ldx, ldw, ldy
        ctypes.c_void_p,  # stream
    ]
    lib.aigv_fp8_matmul.restype = ctypes.c_int


LIB = CudaLibrary("fp8_matmul.cu", _declare)


def quantize_weight_fp8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel e4m3 of a float weight [N, K] -> (float8_e4m3fn
    [N, K], fp32 [N]): scale = max(absmax, 1e-8) / 448, w8 = (w / scale)
    rounded to nearest even. A channel's absmax element lands within one
    fp32 rounding of 448, far below the midpoint to the NaN encoding, so no
    value is NaN."""
    wf = w.float()
    scale = wf.abs().amax(dim=1).clamp_min(1e-8) / E4M3_MAX
    return (wf / scale[:, None]).to(E4M3), scale


def dequantize_weight_fp8(w8: torch.Tensor, scale: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """e4m3 [N, K] and fp32 [N] -> float [N, K]."""
    return (w8.float() * scale[:, None]).to(dtype)


def _check_operands(x, w8, scale) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if w8.dtype != E4M3 or w8.ndim != 2 or w8.shape[1] != x.shape[1]:
        raise ValueError(f"w8 must be float8_e4m3fn [N, {x.shape[1]}], got {w8.dtype} "
                         f"{tuple(w8.shape)}")
    n = w8.shape[0]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be fp32 [{n}], got {scale.dtype} {tuple(scale.shape)}")


def plain_fp8_matmul(
    x: torch.Tensor,  # [M, K] bf16 (or fp32)
    w8: torch.Tensor,  # [N, K] float8_e4m3fn
    scale: torch.Tensor,  # [N] fp32
    out_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's plain version -> [M, N] in `out_dtype` (None: x's dtype):
    the weight cast to x's dtype, the products summed in fp32, the scale
    applied to the fp32 sum, one rounding."""
    _check_operands(x, w8, scale)
    acc = torch.promote_types(x.dtype, torch.float32)
    y = (x.to(acc) @ w8.to(x.dtype).to(acc).t()) * scale
    return y.to(x.dtype if out_dtype is None else out_dtype)


def fp8_matmul(
    x: torch.Tensor,  # [M, K]
    w8: torch.Tensor,  # [N, K] float8_e4m3fn
    scale: torch.Tensor,  # [N] fp32
    out_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """fp8-weight matmul -> [M, N]. On the card: bf16 in and out, any M, N,
    K. A CPU tensor goes to `plain_fp8_matmul`."""
    if x.device.type == "cpu":
        return plain_fp8_matmul(x, w8, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fp8_matmul runs on cuda or cpu, not {x.device}")
    _check_operands(x, w8, scale)
    if x.dtype != torch.bfloat16 or out_dtype not in (None, torch.bfloat16):
        raise TypeError(f"fp8_matmul takes and gives bf16 on the card, got {x.dtype} -> "
                        f"{out_dtype}")
    for t, label in ((w8, "w8"), (scale, "scale")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fp8_matmul: {label} must be contiguous on {x.device}")
    if x.stride(1) != 1:
        x = x.contiguous()
    m, k = x.shape
    n = w8.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = LIB.load()
    with torch.cuda.device(x.device):
        rc = lib.aigv_fp8_matmul(
            x.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
            x.stride(0), w8.stride(0), y.stride(0),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIB.check(rc, "fp8_matmul kernel")
    fp8_matmul.launches += 1
    return y


fp8_matmul.launches = 0


def fp8_dense_apply(x, w8, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense forward over e4m3 weights, x [..., K] -> [..., N]."""
    y = fp8_matmul(x.reshape(-1, x.shape[-1]), w8, scale, out_dtype)
    return y.view(*x.shape[:-1], w8.shape[0])
