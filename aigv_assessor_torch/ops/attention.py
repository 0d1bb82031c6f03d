"""Attention entry points (`aigv_assessor_tpu/ops/attention.py`).

- `fused_qkv_attention`: attention straight off one fused head-major qkv
  array, as the ViT and InternLM2 call it. It goes to the hand-written
  kernels' wrapper (`ops/flash_attention.py`), which launches the CUDA
  kernels for a CUDA tensor (forward, and backward under autograd) and runs
  the plain versions for a CPU tensor.
- `multi_head_attention`: attention on three separate tensors, as the
  weight-only decoder calls it; it goes to the same wrapper module's
  `flash_attention`.
- `plain_attention`: the counterpart of the JAX `xla_attention`, einsums
  with an fp32 softmax. It is the kernels' plain version.

Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] with Hq % Hkv == 0 (GQA).
Queries are grouped as [B, Sq, Hkv, G, D] against their shared KV head, so
repeated K/V heads are never built.
"""

from __future__ import annotations

from typing import Optional

import torch

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

    The JAX entry point also takes a boolean `mask`, which it sends to its
    plain attention. No caller in the port has one yet: it comes with the
    shared-prefix scorer (ROADMAP.md, Queue 1)."""
    from aigv_assessor_torch.ops import flash_attention  # see fused_qkv_attention

    return flash_attention.flash_attention(
        q, k, v, causal=causal, layout=layout, kv_valid=kv_valid
    )
