"""Attention entry points (`aigv_assessor_tpu/ops/attention.py`).

- `fused_qkv_attention`: attention straight off one fused head-major qkv
  array, as the ViT and InternLM2 call it. It goes to the hand-written
  kernels' wrapper (`ops/flash_attention.py`), which launches the CUDA
  kernels for a CUDA tensor (forward, and backward under autograd) and runs
  the plain versions for a CPU tensor.
- `multi_head_attention`: attention on three separate tensors, as the
  weight-only decoder and the QK-normalized ViT call it; it goes to the same
  wrapper module's `flash_attention` (forward, and under autograd its
  logsumexp form and backward kernels).
- `plain_attention`: the counterpart of the JAX `xla_attention`, einsums
  with an fp32 softmax. It is the kernels' plain version.
- `two_part_cached_attention`: attention of a block of new tokens over
  (the read-only KV cache) + (the block itself) with one softmax, in plain
  PyTorch as it is plain JAX einsums there. Prefill into a cache, the
  shared-prefix scorer's suffix pass and decode steps on an int8 cache run
  it; single-token steps on a float cache go to `ops/decode_attention.py`.

Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] with Hq % Hkv == 0 (GQA).
Queries are grouped as [B, Sq, Hkv, G, D] against their shared KV head, so
repeated K/V heads are never built.
"""

from __future__ import annotations

from typing import Optional

import torch

from aigv_assessor_torch.ops.kv_quant import is_quantized

_NEG_INF = -1e30


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Softmax attention with fp32 logits and softmax, scale D**-0.5.

    causal: query i attends to key j <= i + (Skv - Sq).
    mask: bool [B, Sq, Skv], True = attend.
    Products are taken in fp32 (fp64 for fp64 inputs) from the input values,
    the probabilities are rounded to v's dtype before the PV product (as the
    JAX reference and the kernels do), and the result has q's dtype.
    return_lse: also return the logsumexp of the masked logits per row,
    [B, Hq, Sq] in the accumulation dtype, natural-log units."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)

    qg = q.reshape(b, sq, hkv, g, d).to(acc)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)) * d**-0.5
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kj = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(kj <= qi), _NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(acc), v.to(acc))
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)
    return out


def fused_qkv_attention(
    qkv: torch.Tensor,  # [B, hq + 2*hkv, S, D] head-major, [q | k | v]
    hq: int,
    hkv: int,
    *,
    causal: bool = False,
    kv_valid: Optional[int] = None,
    out_layout: str = "bhsd",
) -> torch.Tensor:
    """-> [B, hq, S, D] (`bhsd`) or [B, S, hq*D] (`bsd`, the dense rows the
    W8A8 out-projection reads). kv_valid: keys at or beyond it are masked
    (the caller padded S and the tail holds garbage). Differentiable in
    the `bhsd` layout; `bsd` is forward-only, as in the JAX package."""
    # looked up at call time, so that a caller can swap the kernel for its
    # plain version (chip_smoke.py does, to compare whole forwards); and
    # flash_attention imports this module for plain_attention
    from aigv_assessor_torch.ops import flash_attention

    return flash_attention.flash_attention_qkv(
        qkv, hq, hkv, causal=causal, kv_valid=kv_valid, out_layout=out_layout
    )


def multi_head_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D] (`bshd`) or [B, Hq, Sq, D] (`bhsd`)
    k: torch.Tensor,  # [B, Skv, Hkv, D] or [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bshd",
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head (optionally grouped-query) attention -> q's shape.
    kv_valid: keys at or beyond it are masked (the caller padded Skv).
    Differentiable in q, k and v (`flash_attention.FlashAttention`).

    The JAX entry point also takes a boolean `mask`, which it sends to its
    plain attention. No caller in the port has one."""
    from aigv_assessor_torch.ops import flash_attention  # see fused_qkv_attention

    return flash_attention.flash_attention(
        q, k, v, causal=causal, layout=layout, kv_valid=kv_valid
    )


def two_part_cached_attention(
    q: torch.Tensor,  # [B, S, Hq, D], the current block, rope applied
    k: torch.Tensor,  # [B, S, Hkv, D], the current block, rope applied
    v: torch.Tensor,  # [B, S, Hkv, D]
    cache_k,  # [B, max_len, Hkv, D], read-only, or (int8 data, fp32 scale [B, max_len, Hkv])
    cache_v,
    cache_index: int,  # valid cache rows
    kv_mask: Optional[torch.Tensor] = None,  # [B, max_len] bool
    block_causal: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (read-only old cache) + (current block) with one
    softmax spanning both -> [B, S, Hq, D] in q's dtype.

    Old rows are valid below `cache_index` and where `kv_mask` is set. The
    block is causal; `block_causal=g` makes it S / g independent groups of g
    rows, causal within a group and blind across groups, every group still
    attending the whole cache: the shared-prefix scorer runs its P suffixes
    as one block against one prefix cache. With a `kv_mask` the block's own
    columns, slots [cache_index, cache_index + S), are masked by it too
    (left-padded prefill).

    The cache is never copied here: the caller writes the new rows at
    [cache_index, cache_index + S).

    Logits and softmax are fp32 (fp64 for fp64 inputs); the probabilities
    are rounded to the value dtype before the two PV products, which are
    summed in fp32. With an int8 cache the int8 values enter the products
    directly: the K scale multiplies the logits per (position, kv head) and
    the V scale the probabilities, so no dequantized cache is built. The
    current block's k and v stay unquantized. The order of the arithmetic is
    the JAX function's."""
    k_scale = v_scale = None
    if is_quantized(cache_k):
        cache_k, k_scale = cache_k
        cache_v, v_scale = cache_v
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d**-0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, s, hkv, g, d).to(acc)
    neg = torch.full((), _NEG_INF, dtype=acc, device=q.device)

    lo = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache_k.to(acc)) * scale  # [B, Hkv, G, S, max_len]
    if k_scale is not None:
        lo = lo * k_scale.transpose(1, 2)[:, :, None, None, :]
    slots = torch.arange(cache_k.shape[1], device=q.device)
    valid_old = (slots < cache_index)[None, :]  # slots fill in order
    if kv_mask is not None:
        valid_old = valid_old & kv_mask
    lo = torch.where(valid_old[:, None, None, None, :], lo, neg)

    ln = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)) * scale  # [B, Hkv, G, S, S]
    rows = torch.arange(s, device=q.device)
    valid_new = rows[None, :] <= rows[:, None]
    if block_causal is not None:
        valid_new = valid_new & (
            (rows[:, None] // block_causal) == (rows[None, :] // block_causal)
        )
    valid_new = valid_new[None]
    if kv_mask is not None:
        valid_new = valid_new & kv_mask[:, None, cache_index : cache_index + s]
    ln = torch.where(valid_new[:, None, None], ln, neg)

    m = torch.maximum(lo.amax(dim=-1, keepdim=True), ln.amax(dim=-1, keepdim=True))
    po = torch.exp(lo - m)
    pn = torch.exp(ln - m)
    denom = po.sum(-1, keepdim=True) + pn.sum(-1, keepdim=True)
    po = po / denom
    if v_scale is not None:
        po = (po * v_scale.transpose(1, 2)[:, :, None, None, :]).to(v.dtype)
        cache_v = cache_v.to(v.dtype)
    else:
        po = po.to(cache_v.dtype)
    pn = (pn / denom).to(v.dtype)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", po.to(acc), cache_v.to(acc)) + torch.einsum(
        "bhgqk,bkhd->bqhgd", pn.to(acc), v.to(acc)
    )
    return ctx.reshape(b, s, hq, d).to(q.dtype)
