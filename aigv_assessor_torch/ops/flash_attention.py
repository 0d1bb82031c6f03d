"""Fused-qkv flash-attention forward: CUDA kernel wrapper and plain version.

Replaces the Pallas kernel `aigv_assessor_tpu/ops/pallas_attention.py`
`_fwd_kernel` (`:106`) in the forms `flash_attention_qkv` (`:905`) takes on
the scoring path: forward only, no logsumexp, and either the head-major
`bhsd` output (bf16 serving) or the dense `bsd` output that an
out-projection reads (`dense_out`, W8A8 serving). The kernel source is
`aigv_assessor_torch/csrc/flash_attn_fwd.cu`; its header comment says what
bounds it on the card and how it is laid out.

- `flash_attention_qkv` is the wrapper. On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs the plain version. It counts its
  kernel launches in `flash_attention_qkv.launches`.
- `plain_attention_qkv` is the plain PyTorch version with the same masking.

The kernel is built with nvcc at first use (`ops/cuda_build.py`) and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aigv_assessor_torch.ops.attention import plain_attention
from aigv_assessor_torch.ops.cuda_build import CudaLibrary

HEAD_DIMS = (64, 128)
OUT_LAYOUTS = ("bhsd", "bsd")


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_flash_attn_qkv_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, hq, hkv, S
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D, kv_valid, causal
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # qkv strides b, h, s
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # out strides b, h, s
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
    ]
    lib.aigv_flash_attn_qkv_fwd.restype = ctypes.c_int


LIB = CudaLibrary("flash_attn_fwd.cu", _declare)


def plain_attention_qkv(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D], heads ordered [q | k | v]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
    out_layout: str = "bhsd",
) -> torch.Tensor:
    """The kernel's plain version -> [B, hq, S, D] (`bhsd`) or [B, S, hq*D]
    (`bsd`): fp32 logits and softmax, keys at or beyond `kv_valid` masked."""
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"out_layout {out_layout!r} not in {OUT_LAYOUTS}")
    b, _, s, d = qkv.shape
    q, k, v = (
        t.transpose(1, 2)
        for t in (qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :])
    )
    mask = None
    if kv_valid is not None and kv_valid < s:
        keys = torch.arange(s, device=qkv.device) < kv_valid
        mask = keys[None, None, :].expand(b, s, s)
    out = plain_attention(q, k, v, causal=causal, mask=mask)  # [B, S, hq, D]
    return out.reshape(b, s, hq * d) if out_layout == "bsd" else out.transpose(1, 2)


def _check(qkv: torch.Tensor, hq: int, hkv: int, kv_valid: int, out_layout: str) -> None:
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"out_layout {out_layout!r} not in {OUT_LAYOUTS}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_qkv takes bf16, got {qkv.dtype}")
    if qkv.ndim != 4 or qkv.shape[1] != hq + 2 * hkv:
        raise ValueError(
            f"expected qkv [B, {hq}+2*{hkv}, S, D], got {tuple(qkv.shape)}"
        )
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    d = qkv.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    # rows of D are read as 16-byte vectors: D contiguous, every other
    # stride a multiple of 8 elements, and a 16-byte aligned base
    if qkv.stride(-1) != 1 or any(st % 8 for st in qkv.stride()[:3]):
        raise ValueError(
            f"qkv needs a contiguous head dim and strides that are multiples "
            f"of 8, got {qkv.stride()}"
        )
    if qkv.data_ptr() % 16:
        raise ValueError("qkv data must be 16-byte aligned")
    if not 0 < kv_valid <= qkv.shape[2]:
        raise ValueError(f"kv_valid {kv_valid} outside (0, {qkv.shape[2]}]")


def flash_attention_qkv(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D], heads ordered [q | k | v]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
    out_layout: str = "bhsd",
) -> torch.Tensor:
    """Flash-attention forward off a fused head-major qkv, softmax scale
    D**-0.5 -> [B, hq, S, D] (`bhsd`) or the dense rows [B, S, hq*D] that an
    out-projection reads (`bsd`). The two layouts differ only in where the
    kernel stores each row.

    q head h reads kv head h // (hq // hkv). q/k/v are read in place through
    `qkv`'s strides, so a permuted view of a projection output needs no copy.
    Keys at or beyond `kv_valid` (default S) are masked; `causal` masks keys
    after the query. A CPU tensor goes to `plain_attention_qkv`."""
    if qkv.device.type == "cpu":
        return plain_attention_qkv(
            qkv, hq, hkv, causal=causal, kv_valid=kv_valid, out_layout=out_layout
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv runs on cuda or cpu, not {qkv.device}")
    b, _, s, d = qkv.shape
    kv_valid = s if kv_valid is None else kv_valid
    _check(qkv, hq, hkv, kv_valid, out_layout)
    dense = out_layout == "bsd"
    out = torch.empty(
        (b, s, hq, d) if dense else (b, hq, s, d), dtype=qkv.dtype, device=qkv.device
    )
    # (batch, head, row) strides of the output
    out_strides = (out.stride(0), out.stride(2), out.stride(1)) if dense else out.stride()[:3]
    lib = LIB.load()
    with torch.cuda.device(qkv.device):
        rc = lib.aigv_flash_attn_qkv_fwd(
            qkv.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, kv_valid,
            int(causal), *qkv.stride()[:3], *out_strides, d**-0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    LIB.check(rc, "flash attention kernel")
    flash_attention_qkv.launches += 1
    return out.view(b, s, hq * d) if dense else out


flash_attention_qkv.launches = 0
