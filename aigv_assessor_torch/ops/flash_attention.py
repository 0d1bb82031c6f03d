"""Flash attention: CUDA kernel wrappers and plain versions.

Replaces the Pallas kernels of `aigv_assessor_tpu/ops/pallas_attention.py`.
Those that `flash_attention_qkv` (`:905`) reaches, off one fused head-major
qkv array:

- the forward `_fwd_kernel` (`:106`), in its three forms: head-major `bhsd`
  output without logsumexp (bf16 serving), dense `bsd` output that an
  out-projection reads (`dense_out`, W8A8 serving), and `bhsd` output with
  the per-row logsumexp that the backward reads (`with_lse`, training).
  Source: `aigv_assessor_torch/csrc/flash_attn_fwd.cu`.
- the backward `_bwd_dq_kernel` (`:384`) and `_bwd_dkv_kernel` (`:455`).
  Source: `aigv_assessor_torch/csrc/flash_attn_bwd.cu`.

And those that `flash_attention` (`:689`) reaches, on three separate tensors
in the `bshd` or `bhsd` layout, which the weight-only decoder and the
QK-normalized ViT run: the forward (K2) and its logsumexp form, the second
entry of `csrc/flash_attn_fwd.cu` over the same kernel body, and under
`jax.grad` (`_flash_bwd` `:677`) the same two backward kernels, through the
second pair of entries of `csrc/flash_attn_bwd.cu`.

Each source's header comment says what bounds its kernels on the card and how
they are laid out. The forward (both entries, every form) is one Hopper
kernel: a producer warp loads Q, K and V tiles by TMA into a ring in shared
memory, and two (D = 128) or three (D = 64) consumer warpgroups of 64 query
rows run both products on `wgmma` with the online softmax between them. The
backward is two Hopper kernels built the same way: a dq kernel (one block per
q tile, K and V streamed) and a dk/dv kernel (one block per 128-key tile, the
group's Q and dO tiles streamed), every product on `wgmma`. The tensor maps
are encoded per call from each tensor's pointer and strides; rows past Sq and
kv_valid are zero-filled by TMA and never written, so nothing is padded or
copied.

- `flash_attention` is the three-tensor entry point: the forward without
  logsumexp, or, when q, k or v requires a gradient, `FlashAttention`.
  `flash_attention_lse`, `flash_attention_bwd_dq`, `flash_attention_bwd_dkv`
  wrap its three training kernels and `flash_attention_bwd` is its whole
  backward; `plain_flash_attention(return_lse=)` and
  `plain_flash_attention_bwd` are their plain versions.

- `flash_attention_qkv` is the entry point. Without a gradient to take it is
  the forward-only wrapper; when `qkv` requires a gradient it goes through
  `FlashAttentionQKV`, as the JAX `custom_vjp` splits its primal and `fwd`
  rules.
- `flash_attention_qkv_lse`, `flash_attention_qkv_bwd_dq` and
  `flash_attention_qkv_bwd_dkv` wrap the other three kernels, and
  `flash_attention_qkv_bwd` is the whole backward (both kernels, into one
  `dqkv`).
- On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
  it runs the plain version. Each counts its kernel launches in `.launches`.
- `plain_attention_qkv` and `plain_attention_qkv_bwd` are the plain PyTorch
  versions with the same masking. The backward (`plain_flash_attention_bwd`
  under both) is written from the formulas (p from the saved logsumexp,
  delta, ds), not through autograd, and rounds p and ds to the input dtype
  where the kernels round them to bf16; at fp32 both roundings are the
  identity and it follows the JAX kernels.

A row with no valid key has logsumexp -inf and the backward kernels give it
p = 0. With `kv_valid >= 1`, and the causal mask keeping the diagonal, no row
of the callers' shapes is such a row.

delta = rowsum(dout * out), which the JAX `_bwd` computes outside its kernels,
is computed in fp32 inside the dq kernel on the card: the dq entries take
`out` and write `delta` [B, Hq, Sq], which the dk/dv entries then read. The
plain versions compute it as a PyTorch expression.

The kernels are built with nvcc at first use (`ops/cuda_build.py`) and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from aigv_assessor_torch.ops.attention import plain_attention
from aigv_assessor_torch.ops.cuda_build import CudaLibrary

HEAD_DIMS = (64, 128)
OUT_LAYOUTS = ("bhsd", "bsd")

_STRIDES = [ctypes.c_longlong] * 3  # (batch, head, row), in elements


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_flash_attn_qkv_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, out, lse or null
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, hq, hkv, S
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D, kv_valid, causal
        *_STRIDES, *_STRIDES,  # qkv, out
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
    ]
    lib.aigv_flash_attn_qkv_fwd.restype = ctypes.c_int
    lib.aigv_flash_attn_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, out
        ctypes.c_void_p,  # lse or null
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, hq, hkv, Sq, Skv
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D, kv_valid, causal
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides: q, k, v, out
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
    ]
    lib.aigv_flash_attn_fwd.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    for fn in (lib.aigv_flash_attn_qkv_bwd_dq, lib.aigv_flash_attn_qkv_bwd_dkv):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, out, dout
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lse, delta, dqkv
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, hq, hkv, S
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D, kv_valid, causal
            ctypes.POINTER(ctypes.c_longlong),  # 12 strides: qkv, out, dout, dqkv
            ctypes.c_float, ctypes.c_void_p,  # scale, stream
        ]
        fn.restype = ctypes.c_int
    for fn in (lib.aigv_flash_attn_bwd_dq, lib.aigv_flash_attn_bwd_dkv):
        fn.argtypes = [
            *[ctypes.c_void_p] * 5,  # q, k, v, out, dout
            ctypes.c_void_p, ctypes.c_void_p,  # lse, delta
            *[ctypes.c_void_p] * 3,  # dq, dk, dv (the entry's own outputs; the rest null)
            *[ctypes.c_int] * 8,  # B, hq, hkv, Sq, Skv, D, kv_valid, causal
            ctypes.POINTER(ctypes.c_longlong),  # 24 strides: q, k, v, out, dout, dq, dk, dv
            ctypes.c_float, ctypes.c_void_p,  # scale, stream
        ]
        fn.restype = ctypes.c_int


LIB = CudaLibrary("flash_attn_fwd.cu", _declare)
LIB_BWD = CudaLibrary("flash_attn_bwd.cu", _declare_bwd)


# ------------------------------------------------------------ plain versions --


def _key_mask(qkv: torch.Tensor, kv_valid: Optional[int]) -> Optional[torch.Tensor]:
    b, _, s, _ = qkv.shape
    if kv_valid is None or kv_valid >= s:
        return None
    keys = torch.arange(s, device=qkv.device) < kv_valid
    return keys[None, None, :].expand(b, s, s)


def plain_attention_qkv(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D], heads ordered [q | k | v]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
    out_layout: str = "bhsd",
    return_lse: bool = False,
):
    """The forward kernel's plain version -> [B, hq, S, D] (`bhsd`) or
    [B, S, hq*D] (`bsd`): fp32 logits and softmax, keys at or beyond
    `kv_valid` masked. With `return_lse` also the logsumexp [B, hq, S]."""
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"out_layout {out_layout!r} not in {OUT_LAYOUTS}")
    b, _, s, d = qkv.shape
    q, k, v = (
        t.transpose(1, 2)
        for t in (qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :])
    )
    res = plain_attention(
        q, k, v, causal=causal, mask=_key_mask(qkv, kv_valid), return_lse=return_lse
    )  # [B, S, hq, D], and with return_lse [B, hq, S]
    out, lse = res if return_lse else (res, None)
    out = out.reshape(b, s, hq * d) if out_layout == "bsd" else out.transpose(1, 2)
    return (out, lse) if return_lse else out


def plain_attention_qkv_bwd(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D]
    out: torch.Tensor,  # [B, hq, S, D], the forward's output
    lse: torch.Tensor,  # [B, hq, S], the forward's logsumexp
    dout: torch.Tensor,  # [B, hq, S, D]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """The backward kernels' plain version -> dqkv [B, hq + 2*hkv, S, D]:
    `plain_flash_attention_bwd` on the q, k, v head ranges of `qkv`."""
    grads = plain_flash_attention_bwd(
        qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :], out, lse, dout,
        causal=causal, layout="bhsd", kv_valid=kv_valid)
    return torch.cat(grads, dim=1)


# ----------------------------------------------------------- kernel wrappers --


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
    _check_rows(qkv, "qkv")
    if not 0 < kv_valid <= qkv.shape[2]:
        raise ValueError(f"kv_valid {kv_valid} outside (0, {qkv.shape[2]}]")


def _check_rows(t: torch.Tensor, name: str) -> None:
    # D contiguous, every other stride a multiple of 8 elements and a 16-byte
    # aligned base: what a TMA tensor map describes (the forward) and what
    # 16-byte vector loads of rows need (the backward)
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(
            f"{name} needs a contiguous head dim and strides that are multiples "
            f"of 8, got {t.stride()}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{name} data must be 16-byte aligned")


def _launch_fwd(
    qkv: torch.Tensor, hq: int, hkv: int, causal: bool, kv_valid: Optional[int],
    out_layout: str, with_lse: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv runs on cuda or cpu, not {qkv.device}")
    b, _, s, d = qkv.shape
    kv_valid = s if kv_valid is None else kv_valid
    _check(qkv, hq, hkv, kv_valid, out_layout)
    dense = out_layout == "bsd"
    out = torch.empty(
        (b, s, hq, d) if dense else (b, hq, s, d), dtype=qkv.dtype, device=qkv.device
    )
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=qkv.device) if with_lse else None
    # (batch, head, row) strides of the output
    out_strides = (out.stride(0), out.stride(2), out.stride(1)) if dense else out.stride()[:3]
    lib = LIB.load()
    with torch.cuda.device(qkv.device):
        rc = lib.aigv_flash_attn_qkv_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
            b, hq, hkv, s, d, kv_valid, int(causal), *qkv.stride()[:3], *out_strides,
            d**-0.5, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    LIB.check(rc, "flash attention kernel")
    return (out.view(b, s, hq * d) if dense else out), lse


def flash_attention_qkv_lse(
    qkv: torch.Tensor,
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in the form training runs: -> (out [B, hq, S, D],
    logsumexp [B, hq, S] fp32, natural-log units). `out` is bit-equal to the
    forward without the logsumexp. A CPU tensor goes to the plain version."""
    if qkv.device.type == "cpu":
        return plain_attention_qkv(
            qkv, hq, hkv, causal=causal, kv_valid=kv_valid, return_lse=True
        )
    out, lse = _launch_fwd(qkv, hq, hkv, causal, kv_valid, "bhsd", True)
    flash_attention_qkv_lse.launches += 1
    return out, lse


flash_attention_qkv_lse.launches = 0


def _check_tensor(name: str, label: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: {label} must be {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _launch_bwd(
    name: str, qkv: torch.Tensor, out: Optional[torch.Tensor], dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, dqkv: torch.Tensor, hq: int, hkv: int,
    causal: bool, kv_valid: Optional[int],
) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda, not {qkv.device}")
    b, _, s, d = qkv.shape
    kv_valid = s if kv_valid is None else kv_valid
    _check(qkv, hq, hkv, kv_valid, "bhsd")
    rows = [("dout", dout), ("dqkv", dqkv)] + ([("out", out)] if out is not None else [])
    for label, t in rows:
        shape = qkv.shape if label == "dqkv" else (b, hq, s, d)
        _check_tensor(name, label, t, shape, torch.bfloat16, qkv.device)
        _check_rows(t, label)
    for label, t in (("lse", lse), ("delta", delta)):
        _check_tensor(name, label, t, (b, hq, s), torch.float32, qkv.device)
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError(f"{name}: lse and delta must be contiguous")
    # the dk/dv entry reads no `out`: dout's strides stand in for its own
    strides = [*qkv.stride()[:3], *(dout if out is None else out).stride()[:3],
               *dout.stride()[:3], *dqkv.stride()[:3]]
    lib = LIB_BWD.load()
    with torch.cuda.device(qkv.device):
        rc = getattr(lib, name)(
            qkv.data_ptr(), None if out is None else out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, hq, hkv, s, d, kv_valid,
            int(causal), (ctypes.c_longlong * 12)(*strides), d**-0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    LIB_BWD.check(rc, f"{name} kernel")


def flash_attention_qkv_bwd_dq(
    qkv, out, dout, lse, delta, dqkv, hq: int, hkv: int, *, causal: bool = False,
    kv_valid: Optional[int] = None,
) -> None:
    """dq kernel: writes delta = rowsum(dout * out) in fp32 into `delta`
    [B, hq, S] and heads [0, hq) of `dqkv`, in place. CUDA only."""
    _launch_bwd("aigv_flash_attn_qkv_bwd_dq", qkv, out, dout, lse, delta, dqkv, hq, hkv,
                causal, kv_valid)
    flash_attention_qkv_bwd_dq.launches += 1


def flash_attention_qkv_bwd_dkv(
    qkv, dout, lse, delta, dqkv, hq: int, hkv: int, *, causal: bool = False,
    kv_valid: Optional[int] = None,
) -> None:
    """dk/dv kernel: reads the `delta` the dq kernel wrote and writes heads
    [hq, hq + 2*hkv) of `dqkv` in place, the query heads of a group summed in
    fp32. CUDA only."""
    _launch_bwd("aigv_flash_attn_qkv_bwd_dkv", qkv, None, dout, lse, delta, dqkv, hq, hkv,
                causal, kv_valid)
    flash_attention_qkv_bwd_dkv.launches += 1


flash_attention_qkv_bwd_dq.launches = 0
flash_attention_qkv_bwd_dkv.launches = 0


def _rows_ok(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a contiguous copy where a TMA tensor map cannot describe it."""
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        return t.contiguous()
    return t


def flash_attention_qkv_bwd(
    qkv: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """The whole backward -> dqkv [B, hq + 2*hkv, S, D]: the dq kernel (which
    computes delta) then the dk/dv kernel, each writing its heads of one
    array. A CPU tensor goes to `plain_attention_qkv_bwd`."""
    if qkv.device.type == "cpu":
        return plain_attention_qkv_bwd(
            qkv, out, lse, dout, hq, hkv, causal=causal, kv_valid=kv_valid
        )
    dout = _rows_ok(dout)
    b, _, s, _ = qkv.shape
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    kw = dict(causal=causal, kv_valid=kv_valid)
    flash_attention_qkv_bwd_dq(qkv, out, dout, lse, delta, dqkv, hq, hkv, **kw)
    flash_attention_qkv_bwd_dkv(qkv, dout, lse, delta, dqkv, hq, hkv, **kw)
    return dqkv


class FlashAttentionQKV(torch.autograd.Function):
    """Differentiable fused-qkv attention, `bhsd` layout: the forward with
    logsumexp saves (qkv, out, lse); the backward is the two backward
    kernels. On CPU tensors both directions run the plain versions."""

    @staticmethod
    def forward(ctx, qkv, hq, hkv, causal, kv_valid):
        out, lse = flash_attention_qkv_lse(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
        ctx.save_for_backward(qkv, out, lse)
        ctx.meta = (hq, hkv, causal, kv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        hq, hkv, causal, kv_valid = ctx.meta
        dqkv = flash_attention_qkv_bwd(
            qkv, out, lse, dout, hq, hkv, causal=causal, kv_valid=kv_valid
        )
        return dqkv, None, None, None, None


def flash_attention_qkv(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D], heads ordered [q | k | v]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
    out_layout: str = "bhsd",
) -> torch.Tensor:
    """Flash attention off a fused head-major qkv, softmax scale D**-0.5 ->
    [B, hq, S, D] (`bhsd`) or the dense rows [B, S, hq*D] that an
    out-projection reads (`bsd`). The two layouts differ only in where the
    kernel stores each row.

    q head h reads kv head h // (hq // hkv). q/k/v are read in place through
    `qkv`'s strides, so a permuted view of a projection output needs no copy.
    Keys at or beyond `kv_valid` (default S) are masked; `causal` masks keys
    after the query. A CPU tensor goes to the plain versions.

    When `qkv` requires a gradient the call is differentiable through
    `FlashAttentionQKV` (`bhsd` only: `bsd` is forward-only, as in the JAX
    package); otherwise it is the forward without logsumexp."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        if out_layout != "bhsd":
            raise ValueError(f"out_layout {out_layout!r} is forward-only; 'bhsd' "
                             "is the differentiable layout")
        return FlashAttentionQKV.apply(qkv, hq, hkv, causal, kv_valid)
    if qkv.device.type == "cpu":
        return plain_attention_qkv(
            qkv, hq, hkv, causal=causal, kv_valid=kv_valid, out_layout=out_layout
        )
    out, _ = _launch_fwd(qkv, hq, hkv, causal, kv_valid, out_layout, False)
    flash_attention_qkv.launches += 1
    return out


flash_attention_qkv.launches = 0


# ---------------------------------------------------- three separate tensors --

LAYOUTS = ("bshd", "bhsd")


def _head_major(layout: str, *ts: torch.Tensor):
    """The tensors as [B, H, S, D] views (`bhsd` is already)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    return ts if layout == "bhsd" else tuple(t.transpose(1, 2) for t in ts)


def plain_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bshd",
    kv_valid: Optional[int] = None,
    return_lse: bool = False,
):
    """The three-tensor kernel's plain version: `plain_attention` with the
    keys at or beyond `kv_valid` masked, in either layout. With `return_lse`
    also the logsumexp [B, Hq, Sq] of the masked scaled logits."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if layout == "bhsd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    b, sq = q.shape[:2]
    skv = k.shape[1]
    mask = None
    if kv_valid is not None and kv_valid < skv:
        mask = (torch.arange(skv, device=q.device) < kv_valid)[None, None, :].expand(b, sq, skv)
    res = plain_attention(q, k, v, causal=causal, mask=mask, return_lse=return_lse)
    out, lse = res if return_lse else (res, None)
    out = out.transpose(1, 2) if layout == "bhsd" else out
    return (out, lse) if return_lse else out


def plain_flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output, q's shape
    lse: torch.Tensor,  # [B, Hq, Sq], the forward's logsumexp
    dout: torch.Tensor,  # q's shape
    *,
    causal: bool = False,
    layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain version -> (dq, dk, dv) in the input
    layout and q's dtype.

    p = exp(scale * q.k - lse), 0 where masked; delta = rowsum(dout * out);
    dv = p^T dout; ds = p * (dout.v - delta); dq = scale * ds k;
    dk = scale * ds^T q, dk and dv summed over the query heads of a group.
    Sums run in fp32 (fp64 for fp64 inputs); p and ds are rounded to q's
    dtype before the dv, dq and dk products, where the kernels round them to
    bf16 (the JAX kernels keep them fp32; at fp32 the two agree)."""
    q, k, v, out, dout = _head_major(layout, q, k, v, out, dout)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dtype = q.dtype
    acc = torch.promote_types(dtype, torch.float32)
    scale = d**-0.5
    qg = q.reshape(b, hkv, g, sq, d).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    dog = dout.reshape(b, hkv, g, sq, d).to(acc)

    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    p = torch.exp(logits - lse.to(acc).reshape(b, hkv, g, sq, 1))
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid, diagonal=skv - sq)
    if kv_valid is not None and kv_valid < skv:
        valid[:, kv_valid:] = False
    # where, not a product: a masked logit may have overflowed to inf
    p = torch.where(valid, p, torch.zeros((), dtype=acc, device=q.device))
    del logits
    delta = (dout.to(acc) * out.to(acc)).sum(-1).reshape(b, hkv, g, sq, 1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(dtype).to(acc), dog)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dog, vf) - delta)
    del p
    ds = ds.to(dtype).to(acc)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).reshape(b, hq, sq, d) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return _head_major(layout, dq.to(dtype), dk.to(dtype), dv.to(dtype))


def _separate_dims(q, k, v, causal: bool, layout: str, kv_valid: Optional[int]):
    """Checks q, k, v for the kernels -> (B, Hq, Hkv, Sq, Skv, D, kv_valid,
    (seq axis, head axis))."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    seq, head = (2, 1) if layout == "bhsd" else (1, 2)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.bfloat16 or t.ndim != 4 or t.device != q.device:
            raise TypeError(f"flash_attention takes 4-d bf16 tensors on one device, got {name} "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
        _check_rows(t, name)
    b, d = q.shape[0], q.shape[3]
    sq, hq, skv, hkv = q.shape[seq], q.shape[head], k.shape[seq], k.shape[head]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if causal and sq != skv:
        raise ValueError(f"causal attention needs Sq == Skv, got {sq} and {skv}")
    kv_valid = skv if kv_valid is None else kv_valid
    if not 0 < kv_valid <= skv:
        raise ValueError(f"kv_valid {kv_valid} outside (0, {skv}]")
    return b, hq, hkv, sq, skv, d, kv_valid, (seq, head)


def _strides(ts, axes) -> list:
    """(batch, head, row) strides of each tensor, in elements."""
    seq, head = axes
    return [t.stride(i) for t in ts for i in (0, head, seq)]


def _launch_separate_fwd(q, k, v, causal: bool, layout: str, kv_valid: Optional[int],
                         with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    b, hq, hkv, sq, skv, d, kv_valid, axes = _separate_dims(q, k, v, causal, layout, kv_valid)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = _strides((q, k, v, out), axes)
    lib = LIB.load()
    with torch.cuda.device(q.device):
        rc = lib.aigv_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, hq, hkv, sq, skv, d, kv_valid,
            int(causal), (ctypes.c_longlong * 12)(*strides), d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIB.check(rc, "flash attention kernel")
    return out, lse


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three-tensor forward in the form training runs: -> (out in q's
    shape, logsumexp [B, Hq, Sq] fp32, natural-log units). `out` is bit-equal
    to the forward without the logsumexp. A CPU tensor goes to the plain
    version."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal, layout=layout, kv_valid=kv_valid,
                                     return_lse=True)
    out, lse = _launch_separate_fwd(q, k, v, causal, layout, kv_valid, True)
    flash_attention_lse.launches += 1
    return out, lse


flash_attention_lse.launches = 0


def _launch_separate_bwd(name: str, q, k, v, out, dout, lse, delta, dq, dk, dv, causal: bool,
                         layout: str, kv_valid: Optional[int]) -> None:
    b, hq, hkv, sq, skv, d, kv_valid, axes = _separate_dims(q, k, v, causal, layout, kv_valid)
    rows = [("dout", dout, q), ("out", out, q), ("dq", dq, q), ("dk", dk, k), ("dv", dv, k)]
    for label, t, ref in rows:
        if t is not None:
            _check_tensor(name, label, t, ref.shape, torch.bfloat16, q.device)
            _check_rows(t, label)
    for label, t in (("lse", lse), ("delta", delta)):
        _check_tensor(name, label, t, (b, hq, sq), torch.float32, q.device)
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError(f"{name}: lse and delta must be contiguous")
    # an absent tensor gets a null pointer and the strides of one the entry
    # has (dout's for out, the entry's own output's for the other outputs);
    # the entry reads neither
    own = dq if dq is not None else dk
    strides = _strides((q, k, v, dout if out is None else out, dout,
                        *(own if t is None else t for t in (dq, dk, dv))), axes)
    lib = LIB_BWD.load()
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if out is None else out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (dq, dk, dv)),
            b, hq, hkv, sq, skv, d, kv_valid, int(causal), (ctypes.c_longlong * 24)(*strides),
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIB_BWD.check(rc, f"{name} kernel")


def flash_attention_bwd_dq(
    q, k, v, out, dout, lse, delta, dq, *, causal: bool = False, layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> None:
    """dq kernel on three tensors: writes delta = rowsum(dout * out) in fp32
    into `delta` [B, Hq, Sq] and `dq` (q's shape), in place. CUDA only."""
    _launch_separate_bwd("aigv_flash_attn_bwd_dq", q, k, v, out, dout, lse, delta, dq, None,
                         None, causal, layout, kv_valid)
    flash_attention_bwd_dq.launches += 1


def flash_attention_bwd_dkv(
    q, k, v, dout, lse, delta, dk, dv, *, causal: bool = False, layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> None:
    """dk/dv kernel on three tensors: reads the `delta` the dq kernel wrote
    and writes `dk` and `dv` (k's shape) in place, the query heads of a group
    summed in fp32. CUDA only."""
    _launch_separate_bwd("aigv_flash_attn_bwd_dkv", q, k, v, None, dout, lse, delta, None, dk,
                         dv, causal, layout, kv_valid)
    flash_attention_bwd_dkv.launches += 1


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole three-tensor backward -> (dq, dk, dv), contiguous in the
    input layout: the dq kernel (which computes delta) then the dk/dv kernel.
    A CPU tensor goes to `plain_flash_attention_bwd`."""
    kw = dict(causal=causal, layout=layout, kv_valid=kv_valid)
    if q.device.type == "cpu":
        return plain_flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    dout = _rows_ok(dout)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)  # [B, Hq, Sq]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    flash_attention_bwd_dq(q, k, v, out, dout, lse, delta, dq, **kw)
    flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable attention on three tensors: the forward with
    logsumexp saves (q, k, v, out, lse); the backward is the two backward
    kernels. On CPU tensors both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, layout, kv_valid):
        out, lse = flash_attention_lse(q, k, v, causal=causal, layout=layout, kv_valid=kv_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = dict(causal=causal, layout=layout, kv_valid=kv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.meta)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D] (`bshd`) or [B, Hq, Sq, D] (`bhsd`)
    k: torch.Tensor,  # [B, Skv, Hkv, D] or [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention on three separate tensors, softmax scale D**-0.5 ->
    q's shape, contiguous (so a `bshd` result reshapes to [B, Sq, Hq*D]
    without a copy).

    q head h reads kv head h // (Hq // Hkv). Each tensor is read in place
    through its strides: slices of one projection output and permuted views
    need no copy. `causal` needs Sq == Skv; without it Sq and Skv may differ.
    Keys at or beyond `kv_valid` (default Skv) are masked. On the card: bf16,
    D in (64, 128). A CPU tensor goes to the plain versions.

    When any of q, k, v requires a gradient the call is differentiable
    through `FlashAttention`, as the JAX `custom_vjp` splits its primal and
    `fwd` rules; otherwise it is the forward without logsumexp."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, layout, kv_valid)
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal, layout=layout, kv_valid=kv_valid)
    out, _ = _launch_separate_fwd(q, k, v, causal, layout, kv_valid, False)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
