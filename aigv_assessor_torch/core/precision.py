"""Precision policy, as `aigv_assessor_tpu/core/precision.py` serves it:
bf16 compute with fp32 norm statistics and fp32 scores, and optionally one
of three quantized serving modes.

W8A8 runs both towers' projections as int8 x int8 -> int32 products over
per-channel int8 weights and per-row int8 activations (`ops/w8a8.py`,
`models/lora.W8A8Linear`); the embeddings, the LM head, the projectors, the
score head and SlowFast stay in the compute dtype, SlowFast on cuDNN as the
JAX default keeps it.

The weight-only modes (`int8_weights`, W8A16; `int4_weights`, W4A16) keep the
activations in the compute dtype and store the decoder's projections and the
LM head as per-channel int8 or nibble-packed int4, decoded inside the matmul
kernel (`ops/int8_matmul.py`, `models/lora.Int8Linear` / `Int4Linear`). The
ViT and everything outside the decoder stay float. They exclude W8A8.

Under W8A8, `fuse_quant` and `quant_rows` say in which towers ("vit",
"llm") the projections are fed by the fused quantize kernels
(`ops/quant_fuse.py`), as JAX's `fuse_enabled(component)` and
`quant_rows_enabled(component)` gates say (`aigv_assessor_tpu/ops/
quant_fuse.py:38-71`). `fuse_quant`: the norm -> int8 feeds of both towers
(LayerNorm K4a, RMSNorm K5a), the ViT's tanh-GELU -> fc2 feed (K4b) and the
decoder's SwiGLU -> w2 feed (K5b). `quant_rows`: the attention kernel's
output -> proj / wo feed (K4c; in the decoder on the cache-free branch
only). A tower left out of a set quantizes the producer's output inside the
projection instead. Both default to {"vit"}, JAX's default. The models read
these fields; only the CLI reads JAX's `AIGV_FUSE_QUANT` / `AIGV_QUANT_ROWS`
(`cli/common.quant_components`).

`kv_int8` stores the decoder's KV cache as int8 with one fp32 scale per
(position, kv head) (`ops/kv_quant.py`); it composes with every mode above.

W8A8 of the SlowFast convs (`w8a8_motion`) is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet

import torch

COMPONENTS = frozenset({"vit", "llm"})  # the towers a fused feed can serve


@dataclass(frozen=True)
class Precision:
    compute_dtype: torch.dtype = torch.bfloat16  # weights and activations
    norm_dtype: torch.dtype = torch.float32  # norm statistics
    logits_dtype: torch.dtype = torch.float32  # scores
    w8a8: bool = False  # int8 x int8 projections in both towers
    int8_weights: bool = False  # W8A16: int8 decoder weights, decoded in-kernel
    int4_weights: bool = False  # W4A16: nibble-packed int4 decoder weights
    kv_int8: bool = False  # int8 KV cache with per-(position, kv head) scales
    # W8A8 towers fed by the fused kernels: norms, GELU, SwiGLU / attention output
    fuse_quant: FrozenSet[str] = frozenset({"vit"})
    quant_rows: FrozenSet[str] = frozenset({"vit"})

    def __post_init__(self):
        for name in ("fuse_quant", "quant_rows"):
            value = frozenset(getattr(self, name))
            if not value <= COMPONENTS:
                raise ValueError(f"{name} takes components of {sorted(COMPONENTS)}, "
                                 f"got {sorted(value)}")
            object.__setattr__(self, name, value)
        if self.w8a8 and (self.int8_weights or self.int4_weights):
            raise ValueError(
                "w8a8 excludes int8/int4 weight-only serving: w8a8 quantizes the "
                "projections for int8 products, the others feed int8/int4 weights "
                "into compute-dtype products"
            )

    @property
    def weight_only(self) -> bool:
        return self.int8_weights or self.int4_weights

    @classmethod
    def int8(cls) -> "Precision":
        """bf16 activations over int8 decoder weights (serving)."""
        return cls(int8_weights=True)

    @classmethod
    def fp32(cls) -> "Precision":
        """Full fp32 (CPU parity tests against the JAX package)."""
        return cls(compute_dtype=torch.float32)
