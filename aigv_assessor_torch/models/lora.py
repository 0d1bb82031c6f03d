"""LoRA and quantized dense layers (`aigv_assessor_tpu/models/lora.py`).

`LoRALinear` is the counterpart of `LoRADense` (`:206`) over a float base:
y = base(x) + (alpha / r) * (dropout(x) . A) . B, in its three forms (plain,
head-major out, head-major in). `merge_lora_` folds the adapters into the
base weights, as `aigv_assessor_tpu/tools/merge_lora.py` does.

`W8A8Linear` is the counterpart of `W8A8Dense` (`:98`): int8 weights with
per-output-channel fp32 scales, activations quantized per row on the fly
or handed in pre-quantized by a fused producer (`ops/quant_fuse.py`).

`Int8Linear` and `Int4Linear` are the counterparts of `Int8Dense` (`:28`)
and `Int4Dense` (`:62`): weight-only int8 / nibble-packed int4 under float
activations, decoded inside the matmul kernel (`ops/int8_matmul.py`).

LoRA over a quantized base (W8A8, int8 or int4) is not ported yet
(ROADMAP.md, Queue 1).

Randomness. Dropout draws from an explicit `torch.Generator` that the owner
of the model hands to every stochastic module (`set_generator`), never from
the global generator, so a run is a function of its seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LoRAConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.ops import int8_matmul, w8a8

LORA_LEAVES = ("lora_a", "lora_b")


def is_lora_param(name: str) -> bool:
    """True for an adapter leaf, by its parameter name (dotted) or JAX path
    (slashed)."""
    return name.replace("/", ".").rsplit(".", 1)[-1] in LORA_LEAVES


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator` (on x's device)."""
    if generator is None:
        raise RuntimeError("dropout in training needs a generator: call set_generator first")
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return (x / keep) * mask


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand `generator` to every module of `model` that draws random masks
    (the ones with a `generator` attribute)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


class LoRALinear(nn.Module):
    """A frozen dense layer with a trainable low-rank adapter.

    - `weight` [out, in], `bias`: the base, `nn.Linear`'s layout and names,
      held in the compute dtype.
    - `lora_a` [in, r], `lora_b` [r, out]: the adapter in the JAX layout.
      They may be fp32 masters beside a bf16 base: the forward casts them to
      the input's dtype, as the JAX layer casts its fp32 parameters.
    - dropout acts on the adapter's input only, in training only.

    `heads` set: the output is head-major [B, heads, S, D], a view of the
    dense result (`LoRADense(head_major=...)`). `head_major_in`: the input is
    [B, H, S, D] and is flattened to [B, S, H*D] (`head_major_in=True`)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        lora: LoRAConfig,
        heads: Optional[int] = None,
        head_major_in: bool = False,
    ):
        super().__init__()
        if lora.r <= 0:
            raise ValueError("LoRALinear needs r > 0; use nn.Linear without an adapter")
        if heads and head_major_in:
            raise ValueError("heads and head_major_in exclude each other")
        self.lora = lora
        self.heads = heads
        self.head_major_in = head_major_in
        self.generator: Optional[torch.Generator] = None
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.lora_a = nn.Parameter(torch.zeros(in_features, lora.r))
        self.lora_b = nn.Parameter(torch.zeros(lora.r, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.head_major_in:
            b, h, s, d = x.shape
            x = x.transpose(1, 2).reshape(b, s, h * d)
        y = F.linear(x, self.weight, self.bias)
        h_in = x
        if self.training and self.lora.dropout > 0.0:
            h_in = dropout(x, self.lora.dropout, self.generator)
        delta = (h_in @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        y = y + delta * self.lora.scaling
        if self.heads:
            b, s, _ = y.shape
            y = y.view(b, s, self.heads, -1).transpose(1, 2)
        return y

    def extra_repr(self) -> str:
        out_f, in_f = self.weight.shape
        return (f"in_features={in_f}, out_features={out_f}, bias={self.bias is not None}, "
                f"r={self.lora.r}, alpha={self.lora.alpha}, dropout={self.lora.dropout}, "
                f"heads={self.heads}, head_major_in={self.head_major_in}")


def reject_quantized_lora(precision: Precision, lora: Optional[LoRAConfig]) -> None:
    if lora is None or lora.r <= 0:
        return
    if precision.w8a8:
        raise NotImplementedError(
            "LoRA over a W8A8 base is not ported yet (ROADMAP.md, Queue 1)"
        )
    if precision.weight_only:
        raise NotImplementedError(
            "LoRA over an int8/int4 weight-only base is not ported yet (ROADMAP.md, "
            "Queue 1, item 7)"
        )


def make_linear(
    in_features: int,
    out_features: int,
    bias: bool = True,
    *,
    lora: Optional[LoRAConfig] = None,
    heads: Optional[int] = None,
    head_major_in: bool = False,
) -> nn.Module:
    """`LoRALinear` when an adapter is configured. Without one, a plain
    `nn.Linear`: the callers make the head-major views themselves then, as
    the serving path does."""
    if lora is not None and lora.r > 0:
        return LoRALinear(in_features, out_features, bias, lora=lora, heads=heads,
                          head_major_in=head_major_in)
    return nn.Linear(in_features, out_features, bias=bias)


@torch.no_grad()
def merge_lora_(model: nn.Module) -> nn.Module:
    """Fold every adapter into its base in place, W += (alpha / r) * (A B)^T
    summed in fp32 and rounded once to W's dtype, and zero `lora_b`, so the
    model computes the same function with inert adapters. The merged
    `weight`s load into a model built without LoRA (`lora_free_state_dict`),
    which the serving paths run."""
    for m in model.modules():
        if isinstance(m, LoRALinear):
            delta = (m.lora_a.float() @ m.lora_b.float()) * m.lora.scaling  # [in, out]
            m.weight.copy_(m.weight.float() + delta.t())
            m.lora_b.zero_()
    return model


def lora_free_state_dict(model: nn.Module) -> dict:
    """The state_dict without adapter leaves: what the same config with
    `use_backbone_lora = use_llm_lora = 0` loads. Merge first."""
    return {k: v for k, v in model.state_dict().items() if not is_lora_param(k)}


class QuantizedLinear(nn.Module):
    """Common part of the quantized dense layers: an int8 `weight` buffer
    with one row per output channel, an fp32 `weight_scale` [out] that stays
    fp32 whatever the model is cast to, and an optional float `bias`."""

    def __init__(self, out_features: int, weight_cols: int, bias: bool,
                 out_dtype: torch.dtype):
        super().__init__()
        self.out_dtype = out_dtype
        self.register_buffer("weight", torch.zeros(out_features, weight_cols, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _apply(self, fn, recurse=True):
        # `.to(torch.bfloat16)` casts every floating tensor; the dequant scale
        # stays fp32, as JAX's `cast_params_for_inference` keeps kernel_scale
        # and kernel_scale4. It only follows the device, which `fn` shows on
        # an empty slice.
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


class W8A8Linear(QuantizedLinear):
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
        super().__init__(out_features, in_features, bias, out_dtype)
        self.heads = heads

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


class Int8Linear(QuantizedLinear):
    """W8A16: y = (x @ weight^T) * weight_scale + bias in `out_dtype`, the
    int8 weight cast inside the kernel (`ops/int8_matmul.int8_matmul`).

    - `weight`: int8 [out, in], the JAX `kernel_int8` [in, out] transposed,
      so each output channel's K values are contiguous, as the kernel reads
      them;
    - `weight_scale`: fp32 [out] (`kernel_scale`);
    - `bias`: optional [out], cast with the model."""

    @staticmethod
    def weight_cols(in_features: int) -> int:
        """Bytes of one output channel's row of `weight`."""
        return in_features

    def __init__(self, in_features: int, out_features: int, bias: bool = False, *,
                 out_dtype: torch.dtype = torch.bfloat16):
        super().__init__(out_features, self.weight_cols(in_features), bias, out_dtype)
        self.in_features = in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul.int8_dense_apply(
            x.to(self.out_dtype), self.weight, self.weight_scale, self.bias, self.out_dtype
        )

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.weight.shape[0]}, "
                f"bias={self.bias is not None}, out_dtype={self.out_dtype}")


class Int4Linear(Int8Linear):
    """W4A16: the same over nibble-packed int4 (`ops/int8_matmul.int4_matmul`).

    - `weight`: int8 [out, ceil(in / 2)], the JAX `kernel_int4`
      [ceil(in / 2), out] transposed: byte j of a row packs the channel's
      weights 2j (low nibble) and 2j + 1 (high nibble);
    - `weight_scale`: fp32 [out] (`kernel_scale4`)."""

    @staticmethod
    def weight_cols(in_features: int) -> int:
        return (in_features + 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:  # an odd K shares its byte count with K + 1
            raise ValueError(f"expected {self.in_features} input features, got {x.shape[-1]}")
        return int8_matmul.int4_dense_apply(
            x.to(self.out_dtype), self.weight, self.weight_scale, self.bias, self.out_dtype
        )


def weight_only_linear(precision: Precision):
    """`Int4Linear` or `Int8Linear`, as `LoRADense` picks its base: int4
    first."""
    return Int4Linear if precision.int4_weights else Int8Linear
