"""Precision policy, as `aigv_assessor_tpu/core/precision.py` serves it:
bf16 compute with fp32 norm statistics and fp32 scores, and optionally W8A8.

W8A8 runs both towers' projections as int8 x int8 -> int32 products over
per-channel int8 weights and per-row int8 activations (`ops/w8a8.py`,
`models/lora.W8A8Linear`); the embeddings, the LM head, the projectors, the
score head and SlowFast stay in the compute dtype, SlowFast on cuDNN as the
JAX default keeps it. The weight-only int8/int4 modes, the int8 KV cache and
W8A8 of the SlowFast convs (`w8a8_motion`) are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    compute_dtype: torch.dtype = torch.bfloat16  # weights and activations
    norm_dtype: torch.dtype = torch.float32  # norm statistics
    logits_dtype: torch.dtype = torch.float32  # scores
    w8a8: bool = False  # int8 x int8 projections in both towers

    @classmethod
    def fp32(cls) -> "Precision":
        """Full fp32 (CPU parity tests against the JAX package)."""
        return cls(compute_dtype=torch.float32)
