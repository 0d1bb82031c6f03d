"""Attention entry points (`aigv_assessor_tpu/ops/attention.py`).

- `fused_qkv_attention`: attention straight off one fused head-major qkv
  array, as the ViT and InternLM2 call it. It goes to the hand-written
  kernel's wrapper (`ops/flash_attention.py`), which launches the CUDA
  kernel for a CUDA tensor and runs `plain_attention` for a CPU tensor.
- `plain_attention`: the counterpart of the JAX `xla_attention`, einsums
  with an fp32 softmax. It is the kernel's plain version.

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
) -> torch.Tensor:
    """Softmax attention with fp32 logits and softmax, scale D**-0.5.

    causal: query i attends to key j <= i + (Skv - Sq).
    mask: bool [B, Sq, Skv], True = attend.
    Products are taken in fp32 from the input values, the probabilities are
    rounded to v's dtype before the PV product (as the JAX reference and
    the kernels do), and the result has q's dtype."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv

    qg = q.reshape(b, sq, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kj = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(kj <= qi), _NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


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
    (the caller padded S and the tail holds garbage)."""
    # looked up at call time, so that a caller can swap the kernel for its
    # plain version (chip_smoke.py does, to compare whole forwards); and
    # flash_attention imports this module for plain_attention
    from aigv_assessor_torch.ops import flash_attention

    return flash_attention.flash_attention_qkv(
        qkv, hq, hkv, causal=causal, kv_valid=kv_valid, out_layout=out_layout
    )
