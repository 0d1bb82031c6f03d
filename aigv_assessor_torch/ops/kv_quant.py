"""int8 KV-cache quantization (`aigv_assessor_tpu/ops/kv_quant.py`).

A decode step reads the whole cache of every sample, so its bytes are the
step's second memory term after the weights. Stored as int8 with one fp32
scale per (position, kv head) the cache takes half the bytes of bf16, plus
the scales (4 bytes per D values).

Quantization is symmetric per (batch, position, kv head) over the head_dim
values. The current step's own k/v rows take part in attention unquantized
(the "new" part of `ops/attention.two_part_cached_attention`); only rows read
back from the cache on later steps have been rounded.

A quantized cache is an `(int8 data, fp32 scale)` tuple wherever a cache
tensor would stand: [..., S, Hkv, D] data with a [..., S, Hkv] scale.
"""

from __future__ import annotations

from typing import Tuple

import torch

QuantizedRows = Tuple[torch.Tensor, torch.Tensor]  # (int8 [..., Hkv, D], fp32 [..., Hkv])


def is_quantized(cache_part) -> bool:
    """True if a cache k/v slot holds an (int8 data, scale) tuple."""
    return isinstance(cache_part, tuple)


def quantize_kv_rows(x: torch.Tensor) -> QuantizedRows:
    """[..., S, Hkv, D] float -> (int8 [..., S, Hkv, D], fp32 [..., S, Hkv]).

    Symmetric absmax over the trailing head_dim: scale = amax / 127, values
    rounded half to even and clipped to +-127. A zero row gets scale 1, so
    the stored zeros decode to exact zeros. The scale divides by a tensor:
    a Python-number divisor makes a CUDA division a product with the
    reciprocal, one ulp off the CPU's (and JAX's) scale in some rows."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_kv_rows` (tests; the attention never builds it)."""
    return (q.float() * scale[..., None]).to(dtype)


def make_cache_rows(k: torch.Tensor, v: torch.Tensor, cache_k, cache_v):
    """The new k/v rows an attention layer hands back for the caller to write
    into the cache: quantized when the cache is, cast to the cache's dtype
    otherwise."""
    if is_quantized(cache_k):
        return quantize_kv_rows(k), quantize_kv_rows(v)
    return k.to(cache_k.dtype), v.to(cache_v.dtype)
