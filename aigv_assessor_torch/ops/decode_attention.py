"""Single-token decode attention against the read-only KV cache
(`aigv_assessor_tpu/ops/decode_attention.py`).

One query token per sample attends the rows [starts_b, end) of its sample's
cache and nothing else: with left-padded prompts of different lengths a
sample with a short prompt reads only its own rows. The current token is not
in the cache yet; `merge_new_token` folds it into the kernel's softmax state
afterwards, so the cache is never written before attention.

- `decode_attention`: the kernel's wrapper (`csrc/decode_attention.cu`, built
  with nvcc at first use and loaded with ctypes; replaces the Pallas kernel
  `_decode_kernel`). On a CUDA tensor it launches the kernel or raises; on a
  CPU tensor it runs `plain_decode_attention`. It counts its launches in
  `.launches`. `starts` and `end` stay on the device: nothing here reads them
  on the host.
- `plain_decode_attention`: the plain PyTorch version, written from the
  formula; rows outside the window are masked, not gathered.
- `merge_new_token`, `cached_decode_attention`: plain PyTorch, as they are
  plain JAX in the JAX package. `cached_decode_attention` is the drop-in
  single-token form of `ops/attention.two_part_cached_attention`.
- `decode_kernel_supported`: the shapes the kernel takes. The decoder sends
  every single-token step on a float cache that passes it through the kernel.

Layouts: q [B, Hq, D]; cache k/v [B, max_len, Hkv, D], the model's cache
layout, read in place; D in {64, 128}.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# blocks of the first kernel to aim for, a little more than one per SM of an
# H100: with fewer the card is not filled, with more the combine kernel's
# work grows faster than the first kernel's shrinks
TARGET_BLOCKS = 176
MIN_ROWS_PER_SPLIT = 64
MAX_SPLITS = 32


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_decode_attention.argtypes = [
        *[ctypes.c_void_p] * 5,  # q, k, v, starts, end
        *[ctypes.c_void_p] * 6,  # part_acc, part_m, part_l, out, m, l
        *[ctypes.c_int] * 6,  # B, hq, hkv, max_len, D, nsplit
        *[ctypes.c_longlong] * 8,  # q (batch, head), k and v (batch, row, head)
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
    ]
    lib.aigv_decode_attention.restype = ctypes.c_int


LIB = CudaLibrary("decode_attention.cu", _declare)


def decode_kernel_supported(hq: int, hkv: int, d: int) -> bool:
    """The shapes the kernel takes: a head dim of 64 or 128, grouped query
    heads, at least 8 of them (the JAX package's shape test)."""
    return d in HEAD_DIMS and hkv > 0 and hq % hkv == 0 and hq >= 8


def plain_decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    cache_k: torch.Tensor,  # [B, max_len, Hkv, D]
    cache_v: torch.Tensor,
    starts: torch.Tensor,  # [B] int: first attended row per sample
    end: Union[int, torch.Tensor],  # rows [starts_b, end) are attended
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain version -> (out [B, Hq, D] in q's dtype, m [B, Hq],
    l [B, Hq] in fp32 or wider): scores * D**-0.5 in fp32, rows outside the
    window at -1e30, m their maximum, p = exp(score - m) with 0 outside the
    window, l = sum p, out = (p rounded to the cache dtype) @ v / l, or 0
    where l == 0. An empty window gives out = 0, l = 0, m = -1e30."""
    b, hq, d = q.shape
    _, max_len, hkv, _ = cache_k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    rows = torch.arange(max_len, device=q.device)
    valid = (rows[None, :] >= starts[:, None]) & (rows[None, :] < end)  # [B, max_len]
    qg = q.reshape(b, hkv, g, d).to(acc)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k.to(acc)) * d**-0.5
    valid_s = valid[:, None, None, :]
    s = torch.where(valid_s, s, torch.full((), NEG_INF, dtype=acc, device=q.device))
    m = s.amax(dim=-1)  # [B, Hkv, G]
    p = torch.where(valid_s, torch.exp(s - m[..., None]), torch.zeros((), dtype=acc, device=q.device))
    l = p.sum(dim=-1)
    # rows outside the window may hold anything: a select, not a product
    v = torch.where(valid[:, :, None, None], cache_v, torch.zeros((), dtype=cache_v.dtype,
                                                                  device=q.device))
    ctx = torch.einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype).to(acc), v.to(acc))
    out = ctx / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.reshape(b, hq, d).to(q.dtype), m.reshape(b, hq), l.reshape(b, hq)


def _splits(batch: int, hkv: int, max_len: int) -> int:
    """Pieces each sample's window is cut into, from what the host knows (the
    capacity, not `end`): enough blocks to fill the card, no piece much
    shorter than one block's step."""
    want = -(-TARGET_BLOCKS // (batch * hkv))
    return max(1, min(want, max_len // MIN_ROWS_PER_SPLIT, MAX_SPLITS))


def _check_rows(t: torch.Tensor, name: str) -> None:
    # rows of D are read as 16-byte vectors
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"decode_attention: {name} needs a contiguous head dim, strides that are "
            f"multiples of 8 and a 16-byte aligned base, got strides {t.stride()}"
        )


def _launch(q, cache_k, cache_v, starts, end):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    if q.ndim != 3 or cache_k.ndim != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(
            f"expected q [B, Hq, D] and cache k, v [B, max_len, Hkv, D], got "
            f"{tuple(q.shape)}, {tuple(cache_k.shape)}, {tuple(cache_v.shape)}"
        )
    b, hq, d = q.shape
    _, max_len, hkv, _ = cache_k.shape
    if cache_k.shape[0] != b or cache_k.shape[3] != d:
        raise ValueError(f"cache {tuple(cache_k.shape)} does not match q {tuple(q.shape)}")
    if not decode_kernel_supported(hq, hkv, d):
        raise ValueError(f"decode_attention: unsupported heads {hq}/{hkv} or head dim {d}")
    for t, name in ((q, "q"), (cache_k, "cache_k"), (cache_v, "cache_v")):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"decode_attention takes bf16 on one card, {name} is {t.dtype} "
                            f"on {t.device}")
        _check_rows(t, name)
    if not isinstance(end, torch.Tensor):
        raise TypeError("decode_attention on the card reads `end` from device memory: pass "
                        "an int32 tensor")
    for t, name, numel in ((starts, "starts", b), (end, "end", 1)):
        if (t.dtype != torch.int32 or t.device != q.device or t.numel() != numel
                or not t.is_contiguous()):
            raise ValueError(f"decode_attention: {name} must be {numel} contiguous int32 on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    nsplit = _splits(b, hkv, max_len)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    ml = torch.empty((2, b, hq), dtype=torch.float32, device=q.device)
    # one scratch buffer: part_acc [B, Hq, nsplit, D], then part_m and part_l
    slots = b * hq * nsplit
    scratch = torch.empty(slots * (d + 2), dtype=torch.float32, device=q.device)
    part, m_ptr = scratch.data_ptr(), ml.data_ptr()
    lib = LIB.load()
    with torch.cuda.device(q.device):
        rc = lib.aigv_decode_attention(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), starts.data_ptr(),
            end.data_ptr(), part, part + 4 * slots * d, part + 4 * slots * (d + 1),
            out.data_ptr(), m_ptr, m_ptr + 4 * b * hq, b, hq, hkv, max_len, d, nsplit,
            q.stride(0), q.stride(1), *cache_k.stride()[:3], *cache_v.stride()[:3],
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIB.check(rc, "decode attention kernel")
    return out, ml[0], ml[1]


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    cache_k: torch.Tensor,  # [B, max_len, Hkv, D]
    cache_v: torch.Tensor,
    starts: torch.Tensor,  # [B] int32: first attended row per sample
    end: Union[int, torch.Tensor],  # int32 scalar tensor (an int on the CPU too)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token attention over the cache rows [starts_b, end) -> (out
    [B, Hq, D] in q's dtype, m [B, Hq] fp32, l [B, Hq] fp32) for
    `merge_new_token`. On the card: bf16, `starts` and `end` int32 tensors on
    the card, read by the kernel. A CPU tensor goes to
    `plain_decode_attention`."""
    if q.device.type == "cpu":
        return plain_decode_attention(q, cache_k, cache_v, starts, end)
    res = _launch(q, cache_k, cache_v, starts, end)
    decode_attention.launches += 1
    return res


decode_attention.launches = 0


def merge_new_token(
    out_old: torch.Tensor,  # [B, Hq, D], the kernel's normalised output
    m_old: torch.Tensor,  # [B, Hq]
    l_old: torch.Tensor,  # [B, Hq]
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, 1, Hkv, D], the current token's key
    v_new: torch.Tensor,  # [B, 1, Hkv, D]
) -> torch.Tensor:
    """Fold the current token's own term into the kernel's softmax state: the
    softmax spans (old cache rows) + (this token), as in
    `two_part_cached_attention`."""
    b, hq, d = q.shape
    hkv = k_new.shape[2]
    g = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, d).to(acc)
    kn, vn = k_new[:, 0].to(acc), v_new[:, 0].to(acc)  # [B, Hkv, D]
    s_new = (torch.einsum("bhgd,bhd->bhg", qg, kn) * d**-0.5).reshape(b, hq)
    m_new = torch.maximum(m_old, s_new)
    alpha = torch.exp(m_old - m_new)
    p_new = torch.exp(s_new - m_new)
    denom = l_old * alpha + p_new
    w_old = (l_old * alpha / denom)[..., None]
    w_new = (p_new / denom)[..., None]
    vn_g = vn.repeat_interleave(g, dim=1)  # [B, Hq, D]
    return (out_old.to(acc) * w_old + vn_g * w_new).to(q.dtype)


def cached_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k: torch.Tensor,  # [B, 1, Hkv, D], the current token, rope applied
    v: torch.Tensor,
    cache_k: torch.Tensor,  # [B, max_len, Hkv, D], read-only
    cache_v: torch.Tensor,
    cache_index: Union[int, torch.Tensor],  # valid cache rows; int32 tensor on the card
    kv_mask: Optional[torch.Tensor] = None,  # [B, max_len] bool, left-pad slots False
) -> torch.Tensor:
    """Single-token replacement for `two_part_cached_attention`: the kernel
    over each sample's window [starts_b, cache_index) and the merge of the
    current token. `starts` is the first True of each `kv_mask` row (0 for a
    row with none, whose window the `end = 0` case keeps empty)."""
    b = q.shape[0]
    if kv_mask is not None:
        starts = torch.argmax(kv_mask.to(torch.int32), dim=1).to(torch.int32)
    else:
        starts = torch.zeros((b,), dtype=torch.int32, device=q.device)
    out_old, m_old, l_old = decode_attention(q[:, 0], cache_k, cache_v, starts, cache_index)
    return merge_new_token(out_old, m_old, l_old, q[:, 0], k, v)[:, None]
