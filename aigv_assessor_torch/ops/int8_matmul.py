"""Weight-only quantized matmuls (`aigv_assessor_tpu/ops/int8_matmul.py`):
W8A16 and W4A16 dense layers whose weights are decoded inside the kernel.

    y = (x @ decode(weight)^T) * scale (+ bias)

The sum runs in fp32 over the integer weight values cast to the activation
dtype (exact), the fp32 per-channel scale and the bias are applied to the
fp32 sum, and the result is rounded to the output dtype once. That is the
order of `_kernel` / `_int4_kernel`, not `x @ (weight * scale)`, which rounds
differently in bf16.

Storage. The port stores a weight one row per output channel, as `nn.Linear`
and `W8A8Linear` do, so the K values of a channel are contiguous:

- int8: `weight` [N, K] is the JAX leaf `kernel_int8` [K, N] transposed;
- int4: `weight` [N, ceil(K/2)] is `kernel_int4` [ceil(K/2), N] transposed.
  Byte j of row n packs weight rows 2j (low nibble) and 2j + 1 (high nibble)
  of column n, both two's-complement; an odd K is zero-padded; the scale is
  absmax / 7 and values clip to +-7 (`tools/convert_to_int8.py`).

The kernels read these layouts directly: nothing is transposed or unpacked
at call time.

- `int8_matmul`, `int4_matmul`: the kernels' wrappers
  (`csrc/weight_only_matmul.cu`, built with nvcc at first use and loaded with
  ctypes). On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
  tensor it runs its plain version. Each counts its launches in `.launches`,
  and by form in `.form_launches`.
- `weight_only_form`: which of the kernel's three forms a CUDA call takes,
  from the shapes, strides and pointers: `gemm` (a warp-specialised wgmma
  GEMM on TMA-fed tiles, the weight decoded in registers as the products'
  register-sourced operand), `gemv` (the decode matvec shared with the fp8
  matmul, for at most `GEMV_MAX_ROWS` rows) or `unaligned` (the original
  mma.sync body, for pointers and strides that TMA cannot describe).
- `plain_int8_matmul`, `plain_int4_matmul`: the plain PyTorch versions.
- `int8_dense_apply`, `int4_dense_apply`: any leading dims.
- `quantize_weight`, `quantize_kernel_int4`, `dequantize_kernel`,
  `dequantize_kernel_int4`, `unpack_int4`: the host-side quantizers, the
  port's copies of `tools/convert_to_int8.py` on [N, K] tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary
from aigv_assessor_torch.ops.w8a8 import channel_scale, quantize_kernel

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (int8 weight, fp32 scale [N])

# [N, K] float -> (int8 [N, K], fp32 [N]): absmax / 127 per output channel
# (JAX's `quantize_weight` on the transposed array)
quantize_weight = quantize_kernel


FORMS = ("gemm", "gemv", "unaligned")
# The decode threshold: a call of at most this many rows of x takes the GEMV
# form. On an H100 the GEMV form beat the GEMM form at every M from 4 to 64
# at wqkv and w2, int8 and int4 (tools/weight_only_ab.py, PERF.md): the GEMM
# keeps few SMs busy with one 256-row tile.
GEMV_MAX_ROWS = 64
_ENTRIES = {"gemm": "aigv_weight_only_int{}_gemm", "gemv": "aigv_weight_only_int{}_gemv",
            "unaligned": "aigv_weight_only_int{}_matmul"}


def _declare(lib: ctypes.CDLL, forms=FORMS) -> None:
    for form in forms:
        for bits in (8, 4):
            fn = getattr(lib, _ENTRIES[form].format(bits))
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, weight, scale
                ctypes.c_void_p, ctypes.c_void_p,  # bias or null, y
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, N, K
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # ldx, ldw, ldy
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int


LIB = CudaLibrary("weight_only_matmul.cu", _declare)


# -------------------------------------------------------- host-side quantizers --


def quantize_kernel_int4(w: torch.Tensor) -> Quantized:
    """Per-output-channel symmetric int4 of a float weight [N, K], two values
    per byte along K -> (int8 [N, ceil(K/2)], fp32 [N]). The scale is
    absmax / 7 where absmax > 0, else 1.0."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scale = channel_scale(absmax, 7.0)
    q = torch.round(wf / scale).clamp(-7, 7).to(torch.int16)
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    lo, hi = q[:, 0::2], q[:, 1::2]
    packed = (lo & 0x0F) | ((hi & 0x0F) << 4)  # 0..255
    return packed.to(torch.uint8).view(torch.int8), scale[:, 0]


def unpack_int4(packed: torch.Tensor, in_dim: int) -> torch.Tensor:
    """int8 [N, ceil(K/2)] of packed nibbles -> int8 [N, K] of values in
    [-8, 7], the nibbles sign-extended as `_int4_kernel` does it."""
    lo = ((packed & 0x0F) ^ 8) - 8
    hi = packed >> 4  # arithmetic on int8
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)[:, :in_dim]


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 [N, K] and fp32 [N] -> float [N, K]."""
    return (q.float() * scale[:, None]).to(dtype)


def dequantize_kernel_int4(packed: torch.Tensor, scale: torch.Tensor, in_dim: int,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed int4 [N, ceil(K/2)] and fp32 [N] -> float [N, K]."""
    return dequantize_kernel(unpack_int4(packed, in_dim), scale, dtype)


# ------------------------------------------------------------ plain versions --


def _scaled(x, q, scale, bias, out_dtype) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    y = (x.to(acc) @ q.to(acc).t()) * scale
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype if out_dtype is None else out_dtype)


def plain_int8_matmul(
    x: torch.Tensor,  # [M, K]
    weight: torch.Tensor,  # [N, K] int8
    scale: torch.Tensor,  # [N] fp32
    bias: Optional[torch.Tensor] = None,  # [N]
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The int8 kernel's plain version -> [M, N] in `out_dtype` (default x's):
    products of x with the integer weight values summed in fp32, then the
    scale and the bias in fp32, then one rounding."""
    _check_operands(x, weight, scale, bias, weight_cols=x.shape[1])
    return _scaled(x, weight, scale, bias, out_dtype)


def plain_int4_matmul(
    x: torch.Tensor,  # [M, K]
    weight: torch.Tensor,  # [N, ceil(K/2)] int8, packed nibbles
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The int4 kernel's plain version: the same on the unpacked nibbles."""
    _check_operands(x, weight, scale, bias, weight_cols=(x.shape[1] + 1) // 2)
    return _scaled(x, unpack_int4(weight, x.shape[1]), scale, bias, out_dtype)


# ----------------------------------------------------------- kernel wrappers --


def _check_operands(x, weight, scale, bias, *, weight_cols: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if weight.dtype != torch.int8 or weight.ndim != 2 or weight.shape[1] != weight_cols:
        raise ValueError(
            f"weight must be int8 [N, {weight_cols}] for K={x.shape[1]}, got "
            f"{weight.dtype} {tuple(weight.shape)}"
        )
    n = weight.shape[0]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be fp32 [{n}], got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")


def weight_only_form(m: int, k: int, n: int, bits: int, x: torch.Tensor,
                     weight: torch.Tensor) -> str:
    """The form of the kernel that a CUDA call on x [m, k] and the int8 or
    int4 weight [n, ...] takes: `unaligned` where a base or a row stride is
    off 16 bytes (a TMA tensor map cannot describe it, and the GEMV form's
    16-byte loads would become gathers), else `gemv` for at most
    GEMV_MAX_ROWS rows and `gemm` above. y is the wrapper's own contiguous
    [m, n], which every form stores at any alignment, so n does not enter."""
    row_bytes = k if bits == 8 else (k + 1) // 2
    aligned = (x.data_ptr() % 16 == 0 and x.stride(1) == 1 and x.stride(0) % 8 == 0
               and x.stride(0) >= k and weight.data_ptr() % 16 == 0
               and weight.stride(0) % 16 == 0 and weight.stride(0) >= row_bytes)
    if not aligned:
        return "unaligned"
    return "gemv" if m <= GEMV_MAX_ROWS else "gemm"


def _prepare(bits: int, x, weight, scale, bias, out_dtype) -> torch.Tensor:
    """Checks a CUDA call's operands -> x with unit column stride."""
    name = f"int{bits}_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    _check_operands(x, weight, scale, bias,
                    weight_cols=x.shape[-1] if bits == 8 else (x.shape[-1] + 1) // 2)
    if x.dtype != torch.bfloat16 or out_dtype not in (None, torch.bfloat16):
        raise TypeError(f"{name} takes and gives bf16 on the card, got {x.dtype} -> {out_dtype}")
    if bias is not None and bias.dtype != torch.bfloat16:
        raise TypeError(f"{name}: bias must be bf16, got {bias.dtype}")
    for t, label in ((weight, "weight"), (scale, "scale"), (bias, "bias")):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous on {x.device}")
    return x if x.stride(1) == 1 else x.contiguous()


def _run(form: str, bits: int, x, weight, scale, bias) -> torch.Tensor:
    m, k = x.shape
    y = torch.empty((m, weight.shape[0]), dtype=torch.bfloat16, device=x.device)
    fn = getattr(LIB.load(), _ENTRIES[form].format(bits))
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            m, weight.shape[0], k, x.stride(0), weight.stride(0), y.stride(0),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIB.check(rc, f"int{bits}_matmul {form} kernel")
    return y


def _launch_form(form: str, bits: int, x, weight, scale, bias=None,
                 out_dtype=None) -> torch.Tensor:
    """One named form of the kernel on CUDA tensors, counted nowhere: for the
    card's tests and `tools/weight_only_ab.py`. The gemm form raises on what
    TMA cannot describe."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    x = _prepare(bits, x, weight, scale, bias, out_dtype)
    return _run(form, bits, x, weight, scale, bias)


def _launch(wrapper, bits: int, x, weight, scale, bias, out_dtype) -> torch.Tensor:
    x = _prepare(bits, x, weight, scale, bias, out_dtype)
    form = weight_only_form(x.shape[0], x.shape[1], weight.shape[0], bits, x, weight)
    y = _run(form, bits, x, weight, scale, bias)
    wrapper.launches += 1
    wrapper.form_launches[form] += 1
    return y


def int8_matmul(
    x: torch.Tensor,  # [M, K]
    weight: torch.Tensor,  # [N, K] int8
    scale: torch.Tensor,  # [N] fp32
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """W8A16 matmul -> [M, N]. On the card: bf16 in and out, any M, N, K,
    in the form `weight_only_form` picks. A CPU tensor goes to
    `plain_int8_matmul`."""
    if x.device.type == "cpu":
        return plain_int8_matmul(x, weight, scale, bias, out_dtype)
    return _launch(int8_matmul, 8, x, weight, scale, bias, out_dtype)


def int4_matmul(
    x: torch.Tensor,  # [M, K]
    weight: torch.Tensor,  # [N, ceil(K/2)] int8, packed nibbles
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """W4A16 matmul -> [M, N]. On the card: bf16 in and out, any M, N, K,
    in the form `weight_only_form` picks. A CPU tensor goes to
    `plain_int4_matmul`."""
    if x.device.type == "cpu":
        return plain_int4_matmul(x, weight, scale, bias, out_dtype)
    return _launch(int4_matmul, 4, x, weight, scale, bias, out_dtype)


int8_matmul.launches = 0
int4_matmul.launches = 0
int8_matmul.form_launches = dict.fromkeys(FORMS, 0)
int4_matmul.form_launches = dict.fromkeys(FORMS, 0)


def int8_dense_apply(x, weight, scale, bias=None, out_dtype=None) -> torch.Tensor:
    """Dense forward over int8 weights, x [..., K] -> [..., N]."""
    y = int8_matmul(x.reshape(-1, x.shape[-1]), weight, scale, bias, out_dtype)
    return y.view(*x.shape[:-1], weight.shape[0])


def int4_dense_apply(x, weight, scale, bias=None, out_dtype=None) -> torch.Tensor:
    """Dense forward over nibble-packed int4 weights, x [..., K] -> [..., N]."""
    y = int4_matmul(x.reshape(-1, x.shape[-1]), weight, scale, bias, out_dtype)
    return y.view(*x.shape[:-1], weight.shape[0])
