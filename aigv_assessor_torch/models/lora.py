"""Quantized dense layers (`aigv_assessor_tpu/models/lora.py`).

`W8A8Linear` is the counterpart of `W8A8Dense` (`:98`): int8 weights with
per-output-channel fp32 scales, activations quantized per row on the fly
or handed in pre-quantized by a fused producer (`ops/quant_fuse.py`).
LoRA adapters, `Int8Dense` and `Int4Dense` are not ported yet (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aigv_assessor_torch.ops import w8a8


class W8A8Linear(nn.Module):
    """y = dequant(quantize_rows(x) @ weight^T) + bias in `out_dtype`.

    - `weight`: int8 [out, in] (the JAX `kernel_int8` [in, out], transposed);
    - `weight_scale`: fp32 [out] (`kernel_scale`);
    - `bias`: optional [out], cast with the model like any float weight.

    `heads` set: the output is head-major [B, heads, S, D], a view of the
    dense product (`ops/w8a8.w8a8_head_major`). The input may be a float
    tensor or a pre-quantized (int8, fp32 scale) pair."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        out_dtype: torch.dtype = torch.bfloat16,
        heads: Optional[int] = None,
    ):
        super().__init__()
        self.out_dtype = out_dtype
        self.heads = heads
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _apply(self, fn, recurse=True):
        # `.to(torch.bfloat16)` casts every floating tensor; the dequant scale
        # stays fp32, as JAX's `cast_params_for_inference` keeps kernel_scale.
        # It only follows the device, which `fn` shows on an empty slice.
        scale = self._buffers.pop("weight_scale")
        try:
            super()._apply(fn, recurse)
            device = fn(scale[:0]).device
            if scale.is_meta and device.type != "meta":  # to_empty
                scale = torch.empty_like(scale, device=device)
            else:
                scale = scale.to(device)
        finally:
            self._buffers["weight_scale"] = scale
        return self

    def forward(self, x):
        if self.heads:
            return w8a8.w8a8_head_major(
                x, self.weight, self.weight_scale, self.heads, self.bias, self.out_dtype
            )
        return w8a8.w8a8_matmul(x, self.weight, self.weight_scale, self.bias, self.out_dtype)

    def extra_repr(self) -> str:
        out_f, in_f = self.weight.shape
        return (f"in_features={in_f}, out_features={out_f}, bias={self.bias is not None}, "
                f"heads={self.heads}, out_dtype={self.out_dtype}")
