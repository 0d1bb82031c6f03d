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
  launches in `.launches`, and by form in `.form_launches`. Any M, N and K:
  the kernel handles the edges, the wrapper pads nothing.
- `fp8_form`: which of the kernel's two bodies a CUDA call takes: `stream`
  (a persistent grid of streams, K split over 8 or 16 warps; `matvec_plan`
  mirrors its plan, `matvec_partition` the work each warp derives from it)
  or `tiles` (a block of 8 warps a tile, the body K6 / K7's GEMV form runs).
- `fp8_dense_apply`: any leading dims.

Nothing in the models serves fp8 weights, as nothing in the JAX package
does: the probe (`tools/fp8_decode_probe.py`) is the kernel's one caller.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary

E4M3_MAX = 448.0  # the largest finite float8_e4m3fn value
E4M3 = torch.float8_e4m3fn


FORMS = ("stream", "tiles")
_ENTRIES = {"stream": "aigv_fp8_matmul_stream", "tiles": "aigv_fp8_matmul_tiles"}


def _declare(lib: ctypes.CDLL, entries=tuple(_ENTRIES.values())) -> None:
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w8, scale, y
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, N, K
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # ldx, ldw, ldy
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    if hasattr(lib, "aigv_fp8_matmul_plan"):
        lib.aigv_fp8_matmul_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.aigv_fp8_matmul_plan.restype = ctypes.c_int


LIB = CudaLibrary("fp8_matmul.cu", _declare)

# The launch's work plan, as csrc/decode_matvec.cuh computes it (`plan`): an
# item is 16 output channels x 8 rows of x; a weight row is cut into 64-byte
# steps; a block of 16 warps (one a SM) runs 16 / split streams, the `split`
# warps of a stream sharing each of its items' steps.
CH, ROWS, KSTEP, WARPS, STREAM_WARPS = 16, 8, 64, 8, 16
H100_SMS = 132


class Plan(NamedTuple):
    split: int  # warps that split an item's K: 8 or 16
    streams: int
    per: int  # items of a stream; the first `extra` streams take one more
    extra: int
    blocks: int


def matvec_plan(m: int, n: int, k: int, kpb: int = 1, sms: int = H100_SMS) -> Plan:
    """The stream body's plan at (M, N, K) with `kpb` weight values a byte
    on `sms` SMs: for each split (8, 16), as many streams as the card holds
    at once, at most one an item; of the two, the split whose busiest warp
    streams fewer steps, 8 on a tie."""
    items = -(-n // CH) * -(-m // ROWS)
    steps = -(-(-(-k // kpb)) // KSTEP)
    best, best_steps = None, 0
    for split in (WARPS, STREAM_WARPS):
        streams = min(items, sms * (STREAM_WARPS // split))
        busiest = -(-items // streams) * -(-steps // split)
        if best is None or busiest < best_steps:
            per_block = STREAM_WARPS // split
            best = Plan(split, streams, items // streams, items % streams,
                        -(-streams // per_block))
            best_steps = busiest
    return best


def fp8_form(m: int, k: int, n: int, x: torch.Tensor, w8: torch.Tensor, sms: int) -> str:
    """The form a CUDA call on x [m, k] and w8 [n, k] takes on `sms` SMs:
    `stream` where both start their rows on 16 bytes (the stream body's
    copies need it) and the plan gives the stream something to overlap,
    more than one item a stream or 16 warps an item; else `tiles`, the tile
    body, a block of 8 warps a tile of 16 channels x 8 rows, which was 1-2%
    faster on an H100 where every stream had one item on 8 warps (wqkv)."""
    aligned = (x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0 and w8.data_ptr() % 16 == 0
               and w8.stride(0) % 16 == 0)
    plan = matvec_plan(m, n, k, sms=sms)
    one_item_each = plan.split == WARPS and plan.per == 1 and plan.extra == 0
    return "stream" if aligned and not one_item_each else "tiles"


def matvec_partition(m: int, n: int, k: int, kpb: int = 1, sms: int = H100_SMS):
    """Every (block, warp)'s work as the kernel derives it from the plan ->
    {(block, warp): [(tile, row block, step), ...]} in the order the warp
    streams it; a warp of the last block's idle half has no entry (tests
    hold the result to cover each (tile, row block, step) once)."""
    plan = matvec_plan(m, n, k, kpb, sms)
    rblocks = -(-m // ROWS)
    steps = -(-(-(-k // kpb)) // KSTEP)
    work = {}
    for block in range(plan.blocks):
        for warp in range(STREAM_WARPS):
            sub, wg = divmod(warp, plan.split)
            stream = block * (STREAM_WARPS // plan.split) + sub
            if stream >= plan.streams:
                continue
            i0 = stream * plan.per + min(stream, plan.extra)
            i1 = i0 + plan.per + (stream < plan.extra)
            work[block, warp] = [(item // rblocks, item % rblocks, s) for item in range(i0, i1)
                                 for s in range(wg, steps, plan.split)]
    return work


def launch_plan(m: int, n: int, k: int) -> Plan:
    """The plan that the kernel takes at (M, N, K) on the current CUDA
    device, from the library."""
    out = (ctypes.c_int * 5)()
    LIB.check(LIB.load().aigv_fp8_matmul_plan(m, n, k, out), "fp8_matmul plan")
    return Plan(*out)


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


def _run(form: str, x, w8, scale) -> torch.Tensor:
    m, k = x.shape
    n = w8.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    fn = getattr(LIB.load(), _ENTRIES[form])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
                x.stride(0), w8.stride(0), y.stride(0),
                torch.cuda.current_stream(x.device).cuda_stream)
    LIB.check(rc, f"fp8_matmul {form} kernel")
    return y


def _prepare(x, w8, scale, out_dtype) -> torch.Tensor:
    """Checks a CUDA call's operands -> x with unit column stride."""
    if x.device.type != "cuda":
        raise ValueError(f"fp8_matmul runs on cuda or cpu, not {x.device}")
    _check_operands(x, w8, scale)
    if x.dtype != torch.bfloat16 or out_dtype not in (None, torch.bfloat16):
        raise TypeError(f"fp8_matmul takes and gives bf16 on the card, got {x.dtype} -> "
                        f"{out_dtype}")
    for t, label in ((w8, "w8"), (scale, "scale")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fp8_matmul: {label} must be contiguous on {x.device}")
    return x if x.stride(1) == 1 else x.contiguous()


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_form(form: str, x, w8, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """One named form of the kernel on CUDA tensors, counted nowhere: for the
    card's tests and the A/B tool. The stream form raises on rows off 16
    bytes."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return _run(form, _prepare(x, w8, scale, out_dtype), w8, scale)


def fp8_matmul(
    x: torch.Tensor,  # [M, K]
    w8: torch.Tensor,  # [N, K] float8_e4m3fn
    scale: torch.Tensor,  # [N] fp32
    out_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """fp8-weight matmul -> [M, N]. On the card: bf16 in and out, any M, N,
    K, in the form `fp8_form` picks. A CPU tensor goes to
    `plain_fp8_matmul`."""
    if x.device.type == "cpu":
        return plain_fp8_matmul(x, w8, scale, out_dtype)
    x = _prepare(x, w8, scale, out_dtype)
    m, k = x.shape
    form = fp8_form(m, k, w8.shape[0], x, w8, _sm_count(x.device))
    y = _run(form, x, w8, scale)
    fp8_matmul.launches += 1
    fp8_matmul.form_launches[form] += 1
    return y


fp8_matmul.launches = 0
fp8_matmul.form_launches = dict.fromkeys(FORMS, 0)


def fp8_dense_apply(x, w8, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense forward over e4m3 weights, x [..., K] -> [..., N]."""
    y = fp8_matmul(x.reshape(-1, x.shape[-1]), w8, scale, out_dtype)
    return y.view(*x.shape[:-1], w8.shape[0])
