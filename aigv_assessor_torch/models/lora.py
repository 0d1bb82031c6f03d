"""LoRA and quantized dense layers (`aigv_assessor_tpu/models/lora.py`).

Every tower projection that is not a plain `nn.Linear` is an
`AdaptedLinear`: a base product with the forms and the optional adapter of
the JAX `LoRADense` (`:206`), y = base(x) + (alpha / r) * (dropout(x) . A) . B.
The bases:

- `LoRALinear`: a float weight (`LoRADense` over `nn.Dense`);
- `W8A8Linear`: int8 weights with per-output-channel fp32 scales,
  activations quantized per row on the fly or handed in pre-quantized by a
  fused producer (`ops/quant_fuse.py`) (`W8A8Dense`, `:98`);
- `Int8Linear` / `Int4Linear`: weight-only int8 / nibble-packed int4 under
  float activations, decoded inside the matmul kernel
  (`ops/int8_matmul.py`) (`Int8Dense` `:28`, `Int4Dense` `:62`).

`make_linear` picks one from a precision. `merge_lora_` folds float
adapters into their base weights, as `aigv_assessor_tpu/tools/merge_lora.py`
does; it refuses a quantized base, as that tool merges float kernels only.

Randomness. Dropout draws from an explicit `torch.Generator` that the owner
of the model hands to every stochastic module (`set_generator`), never from
the global generator, so a run is a function of its seed.

Over the `tensor` mesh axis (`parallel/tensor.py`) a `LoRALinear` holds this
rank's share: `split` and `split_role` set, `in_features` and `heads` local.
Column-parallel: the base's and `lora_b`'s output rows, `lora_a` whole;
row-parallel: the base's and `lora_a`'s input columns, `lora_b` whole, the
base's and the adapter's partial products summed in one all-reduce before
the bias. Dropout on a split input draws the mask of the whole activation
from the generator and keeps this rank's columns, so the ranks of a tensor
group, and a run without the axis, draw the same masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LoRAConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.ops import int8_matmul, w8a8
from aigv_assessor_torch.parallel.tensor import (
    ROW,
    copy_to_split,
    full_state_dict,
    split_forward,
)

LORA_LEAVES = ("lora_a", "lora_b")
QUANT_BLOCK = 1 << 24  # values `QuantizedLinear.load_float_weight_` quantizes at once


def is_lora_param(name: str) -> bool:
    """True for an adapter leaf, by its parameter name (dotted) or JAX path
    (slashed)."""
    return name.replace("/", ".").rsplit(".", 1)[-1] in LORA_LEAVES


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            split=None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator` (on x's device).
    `split` (a `parallel/tensor.TensorSplit`): x holds that rank's columns of
    a wider activation; the whole activation's mask is drawn and this rank's
    columns kept."""
    if generator is None:
        raise RuntimeError("dropout in training needs a generator: call set_generator first")
    keep = 1.0 - p
    if split is None:
        mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    else:
        n = x.shape[-1]
        mask = torch.empty(x.shape[:-1] + (n * split.size,), dtype=x.dtype, device=x.device)
        mask = mask.bernoulli_(keep, generator=generator).narrow(-1, split.rank * n, n)
    return (x / keep) * mask


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand `generator` to every module of `model` that draws random masks
    (the ones with a `generator` attribute)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def merged_weight(weight: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor,
                  scaling: float) -> torch.Tensor:
    """W + (alpha / r) * (A B)^T in fp32, for a weight [out, in]."""
    delta = (lora_a.float() @ lora_b.float()) * scaling  # [in, out]
    return weight.float() + delta.t()


class AdaptedLinear(nn.Module):
    """What the projections share: their forms and their adapter.

    - `rows(x)`: [B, S, in] -> [B, S, out], the base plus the adapter's
      delta, whatever form the layer was built for (the cache path calls
      it).
    - `heads` set: `forward` returns head-major [B, heads, S, D], a view of
      the dense result (`LoRADense(head_major=...)`), the delta added before
      the view. `head_major_in`: the input is [B, H, S, D], flattened to
      [B, S, H*D] first (`head_major_in=True`).
    - The adapter (`lora` with r > 0): `lora_a` [in, r], `lora_b` [r, out]
      in the JAX layout. They may be fp32 masters beside a bf16 or int8
      base: the forward casts them to the base's compute dtype, as the JAX
      layer casts its fp32 parameters. The delta reads the float input in
      that dtype, with dropout in training only; a pre-quantized (int8,
      scale) input to an adapted layer raises, as JAX asserts.

    A subclass registers its base leaves, then calls `_init_adapter`, so the
    state_dict keeps the names `weight`, (`weight_scale`), `bias`, `lora_a`,
    `lora_b`, and defines `base(x)` -> [..., out]."""

    def _init_adapter(self, in_features: int, out_features: int, lora: Optional[LoRAConfig],
                      heads: Optional[int], head_major_in: bool) -> None:
        if heads and head_major_in:
            raise ValueError("heads and head_major_in exclude each other")
        self.in_features = in_features
        self.lora = lora if lora is not None and lora.r > 0 else None
        self.heads = heads
        self.head_major_in = head_major_in
        self.generator: Optional[torch.Generator] = None
        self.split = None  # parallel/tensor.split_linear
        self.split_role: Optional[str] = None
        if self.lora is not None:
            self.lora_a = nn.Parameter(torch.zeros(in_features, self.lora.r))
            self.lora_b = nn.Parameter(torch.zeros(self.lora.r, out_features))

    def base(self, x):
        raise NotImplementedError

    def rows(self, x):
        if self.split is not None:
            return self._split_rows(x)
        if self.lora is None:
            return self.base(x)
        if isinstance(x, tuple):
            raise ValueError("an adapted layer needs the float input: its adapter reads the "
                             "activation before quantization, so no fused quantize feed may "
                             "serve it")
        y = self.base(x)
        h = x.to(y.dtype)
        if self.training and self.lora.dropout > 0.0:
            h = dropout(h, self.lora.dropout, self.generator)
        delta = (h @ self.lora_a.to(h.dtype)) @ self.lora_b.to(h.dtype)
        return y + delta * self.lora.scaling

    def _split_rows(self, x: torch.Tensor) -> torch.Tensor:
        """`rows` of a float layer split over `tensor`
        (`parallel/tensor.split_forward`), the adapter's product joining the
        base's before the row-parallel all-reduce."""
        delta = None if self.lora is None else self._split_delta
        return split_forward(x, self.weight, self.bias, self.split, self.split_role, delta)

    def _split_delta(self, x: torch.Tensor) -> torch.Tensor:
        """The adapter's product on a split layer's input: the parameter that
        stays whole meets a split activation, so its gradient is summed over
        the ranks (`copy_to_split`)."""
        split, row = self.split, self.split_role == ROW
        h = x.to(self.weight.dtype)
        if self.training and self.lora.dropout > 0.0:
            h = dropout(h, self.lora.dropout, self.generator, split if row else None)
        a, b = self.lora_a.to(h.dtype), self.lora_b.to(h.dtype)
        if row:
            b = copy_to_split(b, split)
        else:
            a = copy_to_split(a, split)
        return ((h @ a) @ b) * self.lora.scaling

    def forward(self, x):
        if self.head_major_in:
            b, h, s, d = x.shape
            x = x.transpose(1, 2).reshape(b, s, h * d)
        y = self.rows(x)
        if self.heads:
            b, s, _ = y.shape
            y = y.view(b, s, self.heads, -1).transpose(1, 2)
        return y

    def extra_repr(self) -> str:
        lora = (f", r={self.lora.r}, alpha={self.lora.alpha}, dropout={self.lora.dropout}"
                if self.lora is not None else "")
        return (f"in_features={self.in_features}, out_features={self.weight.shape[0]}, "
                f"bias={self.bias is not None}{lora}, heads={self.heads}, "
                f"head_major_in={self.head_major_in}")


class LoRALinear(AdaptedLinear):
    """A frozen float dense layer with a trainable low-rank adapter:
    `weight` [out, in] and `bias` in `nn.Linear`'s layout and names, held in
    the compute dtype."""

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
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self._init_adapter(in_features, out_features, lora, heads, head_major_in)

    def base(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class QuantizedLinear(AdaptedLinear):
    """Common part of the quantized bases: an int8 `weight` buffer with one
    row per output channel, an fp32 `weight_scale` [out] that stays fp32
    whatever the model is cast to, and an optional float `bias`. `quantize`
    makes (weight, weight_scale) from a float weight [out, in];
    `load_float_weight_` stores its result in place."""

    quantize = staticmethod(w8a8.quantize_kernel)

    @staticmethod
    def weight_cols(in_features: int) -> int:
        """Bytes of one output channel's row of `weight`."""
        return in_features

    def __init__(self, in_features: int, out_features: int, bias: bool, *,
                 out_dtype: torch.dtype = torch.bfloat16, lora: Optional[LoRAConfig] = None,
                 heads: Optional[int] = None, head_major_in: bool = False):
        super().__init__()
        self.out_dtype = out_dtype
        self.register_buffer("weight", torch.zeros(out_features, self.weight_cols(in_features),
                                                   dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self._init_adapter(in_features, out_features, lora, heads, head_major_in)

    @torch.no_grad()
    def load_float_weight_(self, w: torch.Tensor) -> None:
        """Quantize a float weight [out, in] into `weight` / `weight_scale`,
        QUANT_BLOCK values of whole rows at a time: the scales are per row,
        so the bits are one call's, and the quantizer's temporaries stay a
        block's size however large the weight (an LM head's are ~3x it)."""
        if tuple(w.shape) != (self.weight.shape[0], self.in_features):
            raise ValueError(f"expected a weight [{self.weight.shape[0]}, {self.in_features}], "
                             f"got {tuple(w.shape)}")
        rows = max(1, QUANT_BLOCK // self.in_features)
        for i in range(0, w.shape[0], rows):
            q, s = self.quantize(w[i:i + rows].to(self.weight.device, torch.float32))
            self.weight[i:i + rows].copy_(q)
            self.weight_scale[i:i + rows].copy_(s)

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

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, out_dtype={self.out_dtype}"


class W8A8Linear(QuantizedLinear):
    """y = dequant(quantize_rows(x) @ weight^T) + bias in `out_dtype`.

    - `weight`: int8 [out, in] (the JAX `kernel_int8` [in, out], transposed);
    - `weight_scale`: fp32 [out] (`kernel_scale`);
    - `bias`: optional [out], cast with the model like any float weight.

    Without an adapter the input may be a float tensor or a pre-quantized
    (int8, fp32 scale) pair."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, **kw):
        super().__init__(in_features, out_features, bias, **kw)

    def base(self, x):
        return w8a8.w8a8_matmul(x, self.weight, self.weight_scale, self.bias, self.out_dtype)


class Int8Linear(QuantizedLinear):
    """W8A16: y = (x @ weight^T) * weight_scale + bias in `out_dtype`, the
    int8 weight cast inside the kernel (`ops/int8_matmul.int8_matmul`).

    - `weight`: int8 [out, in], the JAX `kernel_int8` [in, out] transposed,
      so each output channel's K values are contiguous, as the kernel reads
      them;
    - `weight_scale`: fp32 [out] (`kernel_scale`);
    - `bias`: optional [out], cast with the model."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False, **kw):
        super().__init__(in_features, out_features, bias, **kw)

    def base(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul.int8_dense_apply(
            x.to(self.out_dtype), self.weight, self.weight_scale, self.bias, self.out_dtype
        )


class Int4Linear(Int8Linear):
    """W4A16: the same over nibble-packed int4 (`ops/int8_matmul.int4_matmul`).

    - `weight`: int8 [out, ceil(in / 2)], the JAX `kernel_int4`
      [ceil(in / 2), out] transposed: byte j of a row packs the channel's
      weights 2j (low nibble) and 2j + 1 (high nibble);
    - `weight_scale`: fp32 [out] (`kernel_scale4`)."""

    quantize = staticmethod(int8_matmul.quantize_kernel_int4)

    @staticmethod
    def weight_cols(in_features: int) -> int:
        return (in_features + 1) // 2

    def base(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:  # an odd K shares its byte count with K + 1
            raise ValueError(f"expected {self.in_features} input features, got {x.shape[-1]}")
        return int8_matmul.int4_dense_apply(
            x.to(self.out_dtype), self.weight, self.weight_scale, self.bias, self.out_dtype
        )


def weight_only_linear(precision: Precision):
    """`Int4Linear` or `Int8Linear`, as `LoRADense` picks its base: int4
    first."""
    return Int4Linear if precision.int4_weights else Int8Linear


def make_linear(
    in_features: int,
    out_features: int,
    bias: bool = True,
    *,
    lora: Optional[LoRAConfig] = None,
    heads: Optional[int] = None,
    head_major_in: bool = False,
    precision: Precision = Precision(),
) -> nn.Module:
    """The projection a tower layer holds under `precision`, as `LoRADense`
    picks its base: `W8A8Linear` under W8A8, `Int4Linear` / `Int8Linear`
    under a weight-only mode (both computing in `precision.compute_dtype`),
    each with the adapter when one is configured; else `LoRALinear` with an
    adapter, and without one a plain `nn.Linear`, for which the callers
    make the head-major views themselves, as the serving path does."""
    if lora is not None and lora.r <= 0:
        lora = None
    kw = dict(lora=lora, heads=heads, head_major_in=head_major_in)
    if precision.w8a8:
        return W8A8Linear(in_features, out_features, bias,
                          out_dtype=precision.compute_dtype, **kw)
    if precision.weight_only:
        return weight_only_linear(precision)(in_features, out_features, bias,
                                             out_dtype=precision.compute_dtype, **kw)
    if lora is not None:
        return LoRALinear(in_features, out_features, bias, **kw)
    return nn.Linear(in_features, out_features, bias=bias)


@torch.no_grad()
def merge_lora_(model: nn.Module) -> nn.Module:
    """Fold every adapter into its base in place, W += (alpha / r) * (A B)^T
    summed in fp32 and rounded once to W's dtype (`merged_weight`), and zero
    `lora_b`, so the model computes the same function with inert adapters.
    The merged `weight`s load into a model built without LoRA
    (`lora_free_state_dict`). A quantized base raises ValueError: the JAX
    merge tool merges float kernels only."""
    for m in model.modules():
        if isinstance(m, QuantizedLinear) and m.lora is not None:
            raise ValueError(f"{type(m).__name__}: an adapter over a quantized base does not "
                             "merge; merge the float weights, then quantize")
        if isinstance(m, LoRALinear):
            m.weight.copy_(merged_weight(m.weight, m.lora_a, m.lora_b, m.lora.scaling))
            m.lora_b.zero_()
    return model


def lora_free_state_dict(model: nn.Module) -> dict:
    """The state_dict without adapter leaves: what the same config with
    `use_backbone_lora = use_llm_lora = 0` loads. Merge first. A model split
    over `tensor` gathers its shards into the unsplit layout (a collective
    on every rank of the group)."""
    return {k: v for k, v in full_state_dict(model).items() if not is_lora_param(k)}
