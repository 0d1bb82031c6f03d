"""Rotary position embeddings with dynamic-NTK scaling
(`aigv_assessor_tpu/ops/rope.py`).

The tables are built for a given length with the dynamic-NTK base of that
length, and use the "rotate_half" convention (first half / second half of
the head dim), as InternLM2 does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def ntk_scaled_base(
    base: float,
    dim: int,
    seq_len: int,
    max_position_embeddings: int,
    scaling_factor: float,
) -> float:
    """Dynamic-NTK base: unchanged up to `max_position_embeddings`."""
    if seq_len <= max_position_embeddings:
        return base
    return base * (
        (scaling_factor * seq_len / max_position_embeddings) - (scaling_factor - 1)
    ) ** (dim / (dim - 2))


def rope_cos_sin(
    seq_len: int,
    dim: int,
    base: float = 1_000_000.0,
    scaling_type: Optional[str] = "dynamic",
    scaling_factor: float = 2.0,
    max_position_embeddings: int = 32768,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[seq_len, dim] fp32 cos/sin tables, frequencies repeated across the two
    halves. Built in numpy fp32 exactly as the JAX package builds them."""
    if scaling_type == "dynamic":
        base = ntk_scaled_base(base, dim, seq_len, max_position_embeddings, scaling_factor)
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32)
    if scaling_type == "linear":
        t = t / scaling_factor
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    cos = torch.from_numpy(np.cos(emb).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(emb).astype(np.float32)).to(device)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor,  # [B, Hq, S, D] (`bhsd`) or [B, S, Hq, D] (`bshd`)
    k: torch.Tensor,  # [B, Hkv, S, D] or [B, S, Hkv, D]
    cos: torch.Tensor,  # [rope_len, D]
    sin: torch.Tensor,
    position_ids: torch.Tensor,  # [B, S]
    layout: str = "bhsd",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on head-major (`bhsd`, the fused-qkv paths) or row-major (`bshd`,
    the JAX default, which the weight-only decoder runs) q/k; the tables are
    cast to q's dtype first."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout {layout!r} not in ('bhsd', 'bshd')")
    heads = 1 if layout == "bhsd" else 2  # the axis the tables broadcast over
    cos_g = cos[position_ids].unsqueeze(heads).to(q.dtype)  # [B, 1, S, D] or [B, S, 1, D]
    sin_g = sin[position_ids].unsqueeze(heads).to(q.dtype)
    q_rot = q * cos_g + rotate_half(q) * sin_g
    k_rot = k * cos_g + rotate_half(k) * sin_g
    return q_rot, k_rot
