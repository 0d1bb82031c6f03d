"""Precision policy: bf16 compute with fp32 norm statistics and fp32 scores,
as `aigv_assessor_tpu/core/precision.py` serves it. The quantized serving
modes of the JAX policy (int8, int4, W8A8, int8 KV) are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    compute_dtype: torch.dtype = torch.bfloat16  # weights and activations
    norm_dtype: torch.dtype = torch.float32  # norm statistics
    logits_dtype: torch.dtype = torch.float32  # scores

    @classmethod
    def fp32(cls) -> "Precision":
        """Full fp32 (CPU parity tests against the JAX package)."""
        return cls(compute_dtype=torch.float32)
