"""W8A8 dense ops (`aigv_assessor_tpu/ops/w8a8.py`): int8 x int8 -> int32
products with per-row activation scales and per-channel weight scales.

- Weights are per-output-channel symmetric int8, stored [out, in] with an
  fp32 scale [out] (`quantize_kernel`, the torch copy of
  `tools/convert_to_int8.quantize_kernel`).
- Activations are quantized per row on the fly (`quantize_rows`), or arrive
  as a pre-quantized (int8, fp32 scale) pair from a fused producer kernel
  (`ops/quant_fuse.py`).
- The epilogue applies both scales in fp32, adds the bias in fp32 and casts
  to the compute dtype: `acc * sx * sw (+ bias)`.

The int8 product is `torch._int_mm` (cuBLASLt on the card), as the JAX
package leaves it to XLA's `dot_general`: it is not one of the port's hand
kernels. The weight's [out, in] storage is the column-major B operand that
cuBLASLt's int8 path takes, so `weight.t()` needs no copy.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (int8 [..., K], fp32 [..., 1])
_MIN_ROWS = 16  # cuBLASLt's int8 product takes more rows than this


def quantize_rows(x: torch.Tensor) -> Quantized:
    """Per-row symmetric int8 over the last dim: s = max(absmax, 1e-8) / 127,
    q = clip(round(x / s), -127, 127), rounding half to even. Returns
    (q int8, s fp32 [..., 1]). The division by 127 is by a tensor, so the
    card gives the CPU's bits (see `channel_scale`)."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    sx = ax / torch.full_like(ax, 127.0)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    return xq, sx


def channel_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """absmax / qmax where absmax > 0, else 1.0, by IEEE division on every
    device: a Python-number divisor makes a CUDA tensor's division a product
    with its reciprocal, one ulp off the quotient in some channels, so a
    weight quantized on the card would not be the one JAX (or the CPU)
    stores."""
    return torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax), 1.0)


def quantize_kernel(w: torch.Tensor) -> Quantized:
    """Per-output-channel symmetric int8 of a float weight [out, in]: the
    scale is absmax / 127 where absmax > 0, else 1.0 (not the activations'
    1e-8 floor). Returns (int8 [out, in], fp32 [out])."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scale = channel_scale(absmax, 127.0)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def _as_quantized(x: Union[torch.Tensor, Quantized]) -> Quantized:
    if isinstance(x, tuple):
        xq, sx = x
        if xq.dtype != torch.int8:
            raise TypeError(f"pre-quantized input must be int8, got {xq.dtype}")
        return xq, sx
    return quantize_rows(x)


def _int_mm(xq: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [N, K]^T int8 -> [M, N] int32."""
    if weight.dtype != torch.int8 or weight.ndim != 2 or weight.shape[1] != xq.shape[1]:
        raise ValueError(
            f"weight must be int8 [N, {xq.shape[1]}], got {weight.dtype} {tuple(weight.shape)}"
        )
    if xq.is_cuda:
        m, k = xq.shape
        n = weight.shape[0]
        # cuBLASLt's int8 product: more than 16 rows, K and N multiples of 8
        # (every W8A8 projection of the scoring path meets this)
        if k % 8 or n % 8:
            raise ValueError(
                f"int8 product on the card needs K, N multiples of 8, got K={k} N={n}"
            )
        if not weight.is_contiguous():
            raise ValueError("the int8 weight must be stored [out, in] contiguous")
        if m <= _MIN_ROWS:
            # a decode step has one row per sample: zero rows fill it up
            padded = xq.new_zeros((_MIN_ROWS + 1, k))
            padded[:m] = xq
            return torch._int_mm(padded, weight.t())[:m]
    elif xq.shape[1] < 8:
        # the CPU's int8 product returns wrong sums at K = 1 (torch 2.13); the
        # card takes no K below 8 at all. SlowFast's tiny widths reach here.
        return xq.int() @ weight.int().t()
    return torch._int_mm(xq.contiguous(), weight.t())


def _epilogue(acc, sx, scale, bias, out_dtype) -> torch.Tensor:
    # acc * sx promotes int32 to fp32 in one pass, then in place
    y = acc * sx
    y.mul_(scale)
    if bias is not None:
        y.add_(bias.float())
    return y.to(out_dtype)


def w8a8_dynamic_matmul(
    x: torch.Tensor,  # [..., K] float
    weight: torch.Tensor,  # [N, K] float
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = dequant(quantize_rows(x) @ quant(weight)^T) with both sides
    quantized on the fly, as JAX's `w8a8_dynamic_matmul` computes it for
    frozen float weights outside the int8 checkpoint format (the SlowFast
    pointwise convs): the weight per output channel with s = max(absmax,
    1e-8) / 127 (the activations' floor, not `quantize_kernel`'s 1.0), the
    rows per row, the int32 product, the fp32 epilogue acc * sx * sw."""
    wf = weight.float()
    aw = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    sw = aw / torch.full_like(aw, 127.0)
    wq = torch.round(wf / sw).clamp(-127, 127).to(torch.int8)
    xq, sx = quantize_rows(x)
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y = _epilogue(acc, sx.reshape(-1, 1), sw[:, 0], None, out_dtype)
    return y.view(*lead, weight.shape[0])


def w8a8_matmul(
    x: Union[torch.Tensor, Quantized],  # [..., K] float, or a (q, s) pair
    weight: torch.Tensor,  # [N, K] int8
    scale: torch.Tensor,  # [N] fp32
    bias: Optional[torch.Tensor] = None,  # [N]
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = dequant(quantize_rows(x) @ weight^T) -> [..., N] in `out_dtype`."""
    xq, sx = _as_quantized(x)
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), weight)
    y = _epilogue(acc, sx.reshape(-1, 1), scale, bias, out_dtype)
    return y.view(*lead, weight.shape[0])

