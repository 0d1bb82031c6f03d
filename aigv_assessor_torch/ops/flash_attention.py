"""Fused-qkv flash-attention forward: CUDA kernel wrapper and plain version.

Replaces the Pallas kernel `aigv_assessor_tpu/ops/pallas_attention.py`
`_fwd_kernel` (`:106`) in the form `flash_attention_qkv` (`:905`) takes on
the scoring path: forward only, no logsumexp, `bhsd` output. The kernel
source is `aigv_assessor_torch/csrc/flash_attn_fwd.cu`; its header comment
says what bounds it on the card and how it is laid out.

- `flash_attention_qkv` is the wrapper. On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs the plain version. It counts its
  kernel launches in `flash_attention_qkv.launches`.
- `plain_attention_qkv` is the plain PyTorch version with the same masking.

The kernel is built with nvcc at first use into `build/kernels/` at the root
of the checkout, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from aigv_assessor_torch.ops.attention import plain_attention

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attn_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIBRARY = BUILD_DIR / "libflash_attn_fwd.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
HEAD_DIMS = (64, 128)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the flash-attention kernel needs the CUDA toolkit")


def build_kernel(verbose: bool = False) -> float:
    """Compile the kernel library from the checkout's source if it is missing
    or older than the source. Returns the seconds spent (0.0 if up to date).
    The library is written to a temporary name and renamed, so a process
    building it concurrently never loads a half-written file."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build_kernel()
        lib = ctypes.CDLL(str(LIBRARY))
        lib.aigv_flash_attn_qkv_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, hq, hkv, S
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D, kv_valid, causal
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # strides b, h, s
            ctypes.c_float, ctypes.c_void_p,  # scale, stream
        ]
        lib.aigv_flash_attn_qkv_fwd.restype = ctypes.c_int
        lib.aigv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.aigv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def plain_attention_qkv(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D], heads ordered [q | k | v]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's plain version -> [B, hq, S, D]: fp32 logits and softmax,
    keys at or beyond `kv_valid` masked."""
    b, _, s, _ = qkv.shape
    q, k, v = (
        t.transpose(1, 2)
        for t in (qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :])
    )
    mask = None
    if kv_valid is not None and kv_valid < s:
        keys = torch.arange(s, device=qkv.device) < kv_valid
        mask = keys[None, None, :].expand(b, s, s)
    out = plain_attention(q, k, v, causal=causal, mask=mask)
    return out.transpose(1, 2)


def _check(qkv: torch.Tensor, hq: int, hkv: int, kv_valid: int) -> None:
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
) -> torch.Tensor:
    """Flash-attention forward off a fused head-major qkv -> [B, hq, S, D],
    softmax scale D**-0.5.

    q head h reads kv head h // (hq // hkv). q/k/v are read in place through
    `qkv`'s strides, so a permuted view of a projection output needs no copy.
    Keys at or beyond `kv_valid` (default S) are masked; `causal` masks keys
    after the query. A CPU tensor goes to `plain_attention_qkv`."""
    if qkv.device.type == "cpu":
        return plain_attention_qkv(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv runs on cuda or cpu, not {qkv.device}")
    b, _, s, d = qkv.shape
    kv_valid = s if kv_valid is None else kv_valid
    _check(qkv, hq, hkv, kv_valid)
    out = torch.empty((b, hq, s, d), dtype=qkv.dtype, device=qkv.device)
    lib = _load()
    with torch.cuda.device(qkv.device):
        rc = lib.aigv_flash_attn_qkv_fwd(
            qkv.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, kv_valid,
            int(causal), *qkv.stride()[:3], d**-0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            + lib.aigv_cuda_error_string(rc).decode()
        )
    flash_attention_qkv.launches += 1
    return out


flash_attention_qkv.launches = 0
