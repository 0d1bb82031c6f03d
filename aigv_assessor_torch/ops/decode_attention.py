"""Single-token decode attention against the read-only KV cache
(`aigv_assessor_tpu/ops/decode_attention.py`).

One query token per sample attends the rows [starts_b, end) of its sample's
cache and nothing else: with left-padded prompts of different lengths a
sample with a short prompt reads only its own rows. The current token is not
in the cache yet; it is folded into the window's softmax, so the cache is
never written before attention.

- `cached_decode_attention`: the decoder's entry, the window and the current
  token in one launch of the kernel (`csrc/decode_attention.cu`, built with
  nvcc at first use and loaded with ctypes; replaces the Pallas kernel
  `_decode_kernel` and the `merge_new_token` that follows it in JAX). On a
  CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
  `plain_cached_decode_attention`. It counts its launches in `.launches`.
- `decode_attention`: the window alone -> (out, m, l), JAX's
  `decode_attention`: the same kernel with the merge switched off, counted in
  its own `.launches`; on a CPU tensor `plain_decode_attention`.
- `plain_decode_attention`, `plain_cached_decode_attention`: the plain
  PyTorch versions, written from the formula; rows outside the window are
  masked, not gathered.
- `merge_new_token`: the current token folded into (out, m, l), plain
  PyTorch as it is plain JAX in the JAX package; the decoder's path on the
  card does not call it.
- `window_starts`: each sample's first attended row from the left-padding
  mask, computed once per decode step by the decoder.
- `decode_kernel_supported`: the shapes the kernel takes. The decoder sends
  every single-token step on a float cache that passes it through the kernel.
- `_splits`, `_wide`: the launch's pieces a window and its form (split or
  wide), from B, Hkv, the capacity and the card's SM count.

`starts` and `end` stay on the device: nothing here reads them on the host.
Layouts: q [B, Hq, D]; cache k/v [B, max_len, Hkv, D], the model's cache
layout, read in place; D in {64, 96, 128}.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from aigv_assessor_torch.ops.cuda_build import CudaLibrary

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)
MAX_GROUP = 16  # query heads per kv head: the rows of the kernel's tensor-core tiles
MIN_ROWS_PER_SPLIT = 64  # one tile of the kernel's ring
MAX_SPLITS = 16  # the kernel's largest cluster
_SMS: dict = {}  # device index -> SM count
_MISALIGNED = 716  # cudaErrorMisalignedAddress: a base or stride off 16 bytes


def _declare(lib: ctypes.CDLL) -> None:
    lib.aigv_cached_decode_attention.argtypes = [
        *[ctypes.c_void_p] * 7,  # q, k, v, k_new, v_new, starts, end
        *[ctypes.c_void_p] * 3,  # out, m, l
        *[ctypes.c_int] * 6,  # B, hq, hkv, max_len, D, nsplit
        *[ctypes.c_longlong] * 12,  # q (batch, head), k, v (batch, row, head), k_new, v_new
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
        ctypes.c_int,  # wide: the form of the launch
    ]
    lib.aigv_cached_decode_attention.restype = ctypes.c_int


LIB = CudaLibrary("decode_attention.cu", _declare)


def decode_kernel_supported(hq: int, hkv: int, d: int) -> bool:
    """The shapes the kernel takes: a head dim of 64, 96 or 128, grouped query
    heads, at least 8 of them (the JAX package's shape test), at most 16 to a
    kv head."""
    return (d in HEAD_DIMS and hkv > 0 and hq % hkv == 0 and hq >= 8
            and hq // hkv <= MAX_GROUP)


def window_starts(kv_mask: Optional[torch.Tensor], batch: int,
                  device: torch.device) -> torch.Tensor:
    """int32 [B]: the first True of each `kv_mask` row (0 for a row with none,
    whose window the `end = 0` case keeps empty), or zeros without a mask."""
    if kv_mask is None:
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    return torch.argmax(kv_mask.to(torch.int32), dim=1).to(torch.int32)


def _window(q, cache_k, cache_v, starts, end):
    """Scores, the window mask and v with rows outside it zeroed -> (s
    [B, Hkv, G, max_len], valid [B, max_len], v, accumulation dtype)."""
    b, hq, d = q.shape
    _, max_len, hkv, _ = cache_k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    acc = torch.promote_types(q.dtype, torch.float32)
    rows = torch.arange(max_len, device=q.device)
    valid = (rows[None, :] >= starts[:, None]) & (rows[None, :] < end)  # [B, max_len]
    qg = q.reshape(b, hkv, hq // hkv, d).to(acc)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k.to(acc)) * d**-0.5
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, dtype=acc,
                                                           device=q.device))
    # rows outside the window may hold anything: a select, not a product
    v = torch.where(valid[:, :, None, None], cache_v, torch.zeros((), dtype=cache_v.dtype,
                                                                  device=q.device))
    return s, valid, v, acc


def plain_decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    cache_k: torch.Tensor,  # [B, max_len, Hkv, D]
    cache_v: torch.Tensor,
    starts: torch.Tensor,  # [B] int: first attended row per sample
    end: Union[int, torch.Tensor],  # rows [starts_b, end) are attended
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The window alone -> (out [B, Hq, D] in q's dtype, m [B, Hq], l [B, Hq]
    in fp32 or wider): scores * D**-0.5 in fp32, rows outside the window at
    -1e30, m their maximum, p = exp(score - m) with 0 outside the window,
    l = sum p, out = (p rounded to the cache dtype) @ v / l, or 0 where
    l == 0. An empty window gives out = 0, l = 0, m = -1e30."""
    b, hq, d = q.shape
    s, valid, v, acc = _window(q, cache_k, cache_v, starts, end)
    m = s.amax(dim=-1)  # [B, Hkv, G]
    p = torch.where(valid[:, None, None, :], torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    l = p.sum(dim=-1)
    ctx = torch.einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype).to(acc), v.to(acc))
    out = ctx / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.reshape(b, hq, d).to(q.dtype), m.reshape(b, hq), l.reshape(b, hq)


def plain_cached_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k: torch.Tensor,  # [B, 1, Hkv, D], the current token, rope applied
    v: torch.Tensor,
    cache_k: torch.Tensor,  # [B, max_len, Hkv, D], read-only
    cache_v: torch.Tensor,
    cache_index: Union[int, torch.Tensor],  # rows [starts_b, cache_index) are attended
    kv_mask: Optional[torch.Tensor] = None,  # [B, max_len] bool, left-pad slots False
    starts: Optional[torch.Tensor] = None,  # [B] int, `window_starts(kv_mask)` if given
) -> torch.Tensor:
    """The fused kernel's plain version -> [B, 1, Hq, D] in q's dtype: one
    softmax over the window and the current token, in fp32 (or wider) from
    the scores to the output, rounded once at the end; the window's p
    rounded to the cache dtype for p @ v, as the kernel and the TPU kernel
    round it (a no-op on an fp32 cache)."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    if starts is None:
        starts = window_starts(kv_mask, b, q.device)
    s, valid, vw, acc = _window(q[:, 0], cache_k, cache_v, starts, cache_index)
    qg = q[:, 0].reshape(b, hkv, hq // hkv, d).to(acc)
    kn, vn = k[:, 0].to(acc), v[:, 0].to(acc)  # [B, Hkv, D]
    s_new = torch.einsum("bhgd,bhd->bhg", qg, kn) * d**-0.5
    m = torch.maximum(s.amax(dim=-1), s_new)  # [B, Hkv, G]
    p = torch.where(valid[:, None, None, :], torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    p_new = torch.exp(s_new - m)
    pv = torch.einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype).to(acc), vw.to(acc))
    ctx = pv + p_new[..., None] * vn[:, :, None]
    out = ctx / (p.sum(dim=-1) + p_new)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _splits(batch: int, hkv: int, max_len: int, sms: int) -> int:
    """Pieces each sample's window is cut into, from what the host knows (the
    capacity, not `end`): one block per (kv head, sample, piece), two blocks
    to an SM, and at most 7/8 of those slots, so that the clusters find room
    in one wave (on an H100 at the 2B decode shape: 7 pieces, 224 blocks,
    18.4 us; 8 pieces, 256 blocks, 26 us); no piece shorter than one tile.
    From 116 (kv head, sample) pairs on 132 SMs on, one piece: Phi-3's decode
    step (4 x 32 pairs), the 2B step at B = 16 (16 x 8), which take the wide
    form (`_wide`) while the pairs are no more than the SMs."""
    return max(1, min(2 * sms * 7 // 8 // (batch * hkv), max_len // MIN_ROWS_PER_SPLIT,
                      MAX_SPLITS))


def _wide(batch: int, hkv: int, nsplit: int, sms: int) -> bool:
    """The launch's form. Where each window is one piece and the (kv head,
    sample) pairs are no more than the SMs, the split form's grid would hold
    one block of 4 warps an SM (on an H100 at Phi-3's step: 2.5 TB/s, any
    ring depth); the wide form runs one block of 8 warps an SM over a whole
    window, one tile ahead, two kv heads of a sample in step as a cluster.
    Every other launch takes the split form."""
    return nsplit == 1 and batch * hkv <= sms


def _sm_count(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _launch(q, cache_k, cache_v, starts, end, k_new=None, v_new=None,
            nsplit: Optional[int] = None, wide: Optional[bool] = None):
    """One launch -> out [B, Hq, D] (with k_new / v_new [B, Hkv, D]: the
    current token merged), or (out, m, l) without them. `nsplit` and `wide`
    default to `_splits`' and `_wide`'s. Alignment is checked by the
    kernel's entry, without a host cost."""
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
    merge = k_new is not None
    tensors = (q, cache_k, cache_v, k_new, v_new) if merge else (q, cache_k, cache_v)
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.device != q.device or t.stride(-1) != 1:
            raise TypeError(f"decode_attention takes bf16 with a contiguous head dim on one "
                            f"card, got {t.dtype} {tuple(t.shape)} strides {t.stride()} on "
                            f"{t.device}")
    if merge and not (k_new.shape == v_new.shape == (b, hkv, d)):
        raise ValueError(f"the current token's k, v must be [B, Hkv, D] = {(b, hkv, d)}, got "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if not isinstance(end, torch.Tensor):
        raise TypeError("decode_attention on the card reads `end` from device memory: pass "
                        "an int32 tensor")
    for t, name, numel in ((starts, "starts", b), (end, "end", 1)):
        if (t.dtype != torch.int32 or t.device != q.device or t.numel() != numel
                or not t.is_contiguous()):
            raise ValueError(f"decode_attention: {name} must be {numel} contiguous int32 on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    index = q.device.index
    if nsplit is None:
        nsplit = _splits(b, hkv, max_len, _sm_count(index))
    if wide is None:
        wide = _wide(b, hkv, nsplit, _sm_count(index))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    ml = None if merge else torch.empty((2, b, hq), dtype=torch.float32, device=q.device)
    kn, vn = (k_new.data_ptr(), v_new.data_ptr()) if merge else (None, None)
    m_ptr = None if merge else ml.data_ptr()
    l_ptr = None if merge else m_ptr + 4 * b * hq
    news = (*k_new.stride()[:2], *v_new.stride()[:2]) if merge else (0, 0, 0, 0)
    lib = LIB.load()
    args = (q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), kn, vn, starts.data_ptr(),
            end.data_ptr(), out.data_ptr(), m_ptr, l_ptr, b, hq, hkv, max_len, d, nsplit,
            *q.stride()[:2], *cache_k.stride()[:3], *cache_v.stride()[:3], *news, d**-0.5,
            torch.cuda.current_stream(index).cuda_stream, int(wide))
    if index == torch.cuda.current_device():
        rc = lib.aigv_cached_decode_attention(*args)
    else:
        with torch.cuda.device(index):
            rc = lib.aigv_cached_decode_attention(*args)
    if rc == _MISALIGNED:
        raise ValueError("decode_attention reads 16-byte vectors: q, the cache and the "
                         "current token's k and v need 16-byte aligned bases and strides "
                         "that are multiples of 8")
    LIB.check(rc, "decode attention kernel")
    return out if merge else (out, ml[0], ml[1])


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
    starts: Optional[torch.Tensor] = None,  # [B] int32, `window_starts(kv_mask)` if given
) -> torch.Tensor:
    """Single-token replacement for `two_part_cached_attention` -> [B, 1, Hq,
    D]: the softmax over each sample's window [starts_b, cache_index) and the
    current token. `starts` defaults to `window_starts(kv_mask)`; a decoder
    passes it in, computed once for all its layers. On the card one launch;
    a CPU tensor goes to `plain_cached_decode_attention`."""
    if q.device.type == "cpu":
        return plain_cached_decode_attention(q, k, v, cache_k, cache_v, cache_index, kv_mask,
                                             starts)
    if starts is None:
        starts = window_starts(kv_mask, q.shape[0], q.device)
    out = _launch(q[:, 0], cache_k, cache_v, starts, cache_index, k[:, 0], v[:, 0])
    cached_decode_attention.launches += 1
    return out[:, None]


cached_decode_attention.launches = 0
