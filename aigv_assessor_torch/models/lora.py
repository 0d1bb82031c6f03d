"""LoRA and quantized dense layers (`aigv_assessor_tpu/models/lora.py`).

`LoRALinear` is the counterpart of `LoRADense` (`:206`) over a float base:
y = base(x) + (alpha / r) * (dropout(x) . A) . B, in its three forms (plain,
head-major out, head-major in). `merge_lora_` folds the adapters into the
base weights, as `aigv_assessor_tpu/tools/merge_lora.py` does.

`W8A8Linear` is the counterpart of `W8A8Dense` (`:98`): int8 weights with
per-output-channel fp32 scales, activations quantized per row on the fly
or handed in pre-quantized by a fused producer (`ops/quant_fuse.py`).
LoRA over a W8A8 base, `Int8Dense` and `Int4Dense` are not ported yet
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
from aigv_assessor_torch.ops import w8a8

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


def reject_w8a8_lora(precision: Precision, lora: Optional[LoRAConfig]) -> None:
    if precision.w8a8 and lora is not None and lora.r > 0:
        raise NotImplementedError(
            "LoRA over a W8A8 base is not ported yet (ROADMAP.md, Queue 1)"
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
    """Fold every adapter into its base in place, W += (alpha / r) * (A B)^T,
    and zero `lora_b`, so the model computes the same function with inert
    adapters. The merged `weight`s load into a model built without LoRA
    (`lora_free_state_dict`), which the serving paths run."""
    for m in model.modules():
        if isinstance(m, LoRALinear):
            delta = (m.lora_a.float() @ m.lora_b.float()) * m.lora.scaling  # [in, out]
            m.weight += delta.t().to(m.weight.dtype)
            m.lora_b.zero_()
    return model


def lora_free_state_dict(model: nn.Module) -> dict:
    """The state_dict without adapter leaves: what the same config with
    `use_backbone_lora = use_llm_lora = 0` loads. Merge first."""
    return {k: v for k, v in model.state_dict().items() if not is_lora_param(k)}


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
