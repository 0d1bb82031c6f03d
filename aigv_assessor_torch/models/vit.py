"""InternViT vision encoder (`aigv_assessor_tpu/models/vit.py`): InternViT-300M
(InternVL2-2B) and InternViT-6B (InternVL2-26B).

Patch embedding (14x14 conv, stride 14), class token, learned position
embedding, then pre-norm layers with LayerScale: attention off one fused qkv
projection through the flash-attention kernel, and a tanh-GELU MLP.

With `qk_normalization` (InternViT-6B: RMSNorm layers, no qkv bias) the
layer follows the JAX layer's other branch (`models/vit.py:199-226`): `qkv`
is a dense [B, N, 3C] projection; q and k go through `q_norm` / `k_norm`, an
RMSNorm over the flattened C; the three [B, N, H, D] tensors go to
`multi_head_attention` (the three-tensor kernel K2 in `bshd`, and in
training its logsumexp form and backward); `proj` is a dense projection.
Under W8A8 both are dense `W8A8Linear`s with no head-major view, the
RMSNorm feeds unfused, as in JAX.

The input may be at another size than the position embedding's grid: its
grid part is then resized to the input's patch grid by torch's bicubic in
fp32 (`ops/resize.bicubic_resize_grid`, JAX `:120-134`). `select_layer`
runs `select_layer % (L + 1)` layers, the reference's
`hidden_states[select_layer]` (JAX `:363-368`).

The weight-only modes (int8, int4) quantize the decoder alone, as JAX's
`quantize_tree(scope="language_model")`: the tower stays float under them.

The public layout is the JAX package's: pixels [B, H, W, 3]. The encoder
pads the token axis once, 1025 -> 1032 at 448 px, as the JAX encoder does;
the pad rows evolve through the layers, so attention masks keys at or beyond
the real token count (`kv_valid`), and the pad is cut off at the end.

Under W8A8 (`Precision.w8a8`) the four projections are `W8A8Linear`s and
are fed as the JAX layer feeds them (`aigv_assessor_tpu/models/vit.py:150-197`,
`:229-266`, `:298-326`). With "vit" in `Precision.fuse_quant` (the default)
norm1 and norm2 go through the fused LayerNorm + quantize kernel (K4a) and
fc1's output through the fused tanh-GELU + quantize (K4b) into fc2; with
"vit" in `Precision.quant_rows` (the default) the attention kernel's dense
`bsd` rows go through the one-pass quantize (K4c) into `proj`. Without them
the norm, the GELU or the attention writes its compute-dtype output and the
projection quantizes it, as JAX does with its gates off. The pad rows go
through the feeds like any row.

Adapters (`lora` set): the four projections carry them, over a float or
(in evaluation) a W8A8 base. Under W8A8 the delta reads the float
activation, so the K4a-c feeds are off, as in JAX (`:182`, `:249`, `:304`).
Training (`module.train()`): the projections are `LoRALinear`s, `qkv`
head-major out and `proj` head-major in, so attention stays on the
fused-qkv kernel and its backward kernels (with `qk_normalization`, dense
projections around the three-tensor kernel and its backward kernels); each
residual branch is dropped per sample with rates linspace(0, drop_path_rate,
L) (stochastic depth); with `grad_checkpoint` each layer's activations are
recomputed in the backward (`ops/remat.py`), or, under `remat_policy`, what
the policy does not save. In `eval()` the layers are deterministic.

Over the `tensor` mesh axis (`parallel/tensor.py`, `split_`) a float tower
holds this rank's heads: `qkv` cut by heads ([q | k | v], each rank its
heads of each), `proj` by input features, `fc1` by output features, `fc2`
by input features; `num_heads` is local, and the layer's norms, LayerScale and
residual stay whole, the row-parallel outputs summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LoRAConfig, VisionConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.lora import AdaptedLinear, LoRALinear, make_linear
from aigv_assessor_torch.ops import quant_fuse
from aigv_assessor_torch.ops.attention import fused_qkv_attention, multi_head_attention
from aigv_assessor_torch.ops.norms import LayerNorm, RMSNorm
from aigv_assessor_torch.ops.remat import checkpoint_layer, policy_fn
from aigv_assessor_torch.ops.resize import bicubic_resize_grid
from aigv_assessor_torch.parallel.tensor import (
    COLUMN,
    ROW,
    split_linear,
    split_norm_,
    split_rms_norm,
)


def make_norm(norm_type: str, dim: int, eps: float) -> nn.Module:
    return RMSNorm(dim, eps) if norm_type == "rms_norm" else LayerNorm(dim, eps)


def tower_precision(precision: Precision) -> Precision:
    """The precision of the tower's projections: W8A8 or float, never
    weight-only (those modes quantize the decoder alone)."""
    return dataclasses.replace(precision, int8_weights=False, int4_weights=False)


class InternVisionEmbeddings(nn.Module):
    def __init__(self, config: VisionConfig):
        super().__init__()
        self.config = config
        c = config.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, c))
        self.position_embedding = nn.Parameter(torch.zeros(1, config.num_patches + 1, c))
        self.patch_embedding = nn.Conv2d(
            config.num_channels, c, config.patch_size, stride=config.patch_size
        )

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 1 + (H/p)*(W/p), C]."""
        cfg = self.config
        dtype = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixel_values.to(dtype).permute(0, 3, 1, 2))
        b, c, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, C], row-major over (h, w)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        pos = self.position_embedding
        side = cfg.num_patches_per_side
        if (h, w) != (side, side):
            # the grid part, resized to the input's patch grid
            grid = bicubic_resize_grid(pos[:, 1:].reshape(1, side, side, c), h, w)
            pos = torch.cat([pos[:, :1], grid.reshape(1, h * w, c)], dim=1)
        return x + pos.to(x.dtype)


class InternAttention(nn.Module):
    """Split over `tensor` (`split_`), the layer holds this rank's
    `num_heads` of the config's: `qkv` cut by heads, `proj` by rows, and
    with `qk_normalization` this rank's columns of `q_norm` / `k_norm`, whose
    mean square over all heads sums the ranks' partial sums of squares."""

    TENSOR_ROLES = {"qkv": COLUMN, "proj": ROW}

    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        precision = tower_precision(precision)
        self.num_heads = h = config.num_attention_heads
        self.head_dim = config.hidden_size // h
        self.split = None
        self.qk_normalization = config.qk_normalization
        self.w8a8 = precision.w8a8
        adapted = lora is not None and lora.r > 0
        self.quant_rows = precision.w8a8 and "vit" in precision.quant_rows and not adapted
        c = config.hidden_size
        if self.qk_normalization:
            self.qkv = make_linear(c, 3 * c, bias=config.qkv_bias, lora=lora,
                                   precision=precision)
            self.q_norm = RMSNorm(c, config.layer_norm_eps)
            self.k_norm = RMSNorm(c, config.layer_norm_eps)
            self.proj = make_linear(c, c, lora=lora, precision=precision)
        else:
            # qkv head-major out; proj dense under W8A8 (the kernel writes its
            # `bsd` rows), else head-major in
            self.qkv = make_linear(c, 3 * c, bias=config.qkv_bias, lora=lora, heads=3 * h,
                                   precision=precision)
            self.proj = make_linear(c, c, lora=lora, head_major_in=not self.w8a8,
                                    precision=precision)

    def tensor_divides(self, size: int) -> bool:
        return self.num_heads % size == 0

    def split_(self, split) -> None:
        """Keep this rank's heads (`parallel/tensor.py`), in place."""
        c = self.num_heads * self.head_dim
        self.qkv = split_linear(self.qkv, COLUMN, split, (c, c, c))
        self.proj = split_linear(self.proj, ROW, split)
        if self.qk_normalization:
            split_norm_(self.q_norm, split)
            split_norm_(self.k_norm, split)
        self.num_heads //= split.size
        self.split = split

    def _qk_norm(self, norm: RMSNorm, x: torch.Tensor) -> torch.Tensor:
        if self.split is None:
            return norm(x)
        return split_rms_norm(x, norm.weight, norm.eps, self.split)

    def forward(self, x, kv_valid: int | None = None) -> torch.Tensor:
        """x: [B, N, C], or under W8A8 its (int8, scale) rows."""
        h, d = self.num_heads, self.head_dim
        if self.qk_normalization:
            b, n, _ = x.shape
            c = h * d  # this rank's heads' width
            q, k, v = self.qkv(x).split(c, dim=-1)  # each [B, N, c]; v a strided view
            q = self._qk_norm(self.q_norm, q).view(b, n, h, d)
            k = self._qk_norm(self.k_norm, k).view(b, n, h, d)
            out = multi_head_attention(q, k, v.view(b, n, h, d), causal=False,
                                       kv_valid=kv_valid)  # [B, N, H, D]
            return self.proj(out.reshape(b, n, c))
        if isinstance(self.qkv, LoRALinear):
            # head-major out -> attention -> head-major in: [B, 3H, N, D] ->
            # [B, H, N, D] -> [B, N, C]
            out = fused_qkv_attention(self.qkv(x), h, h, causal=False, kv_valid=kv_valid)
            return self.proj(out)
        if isinstance(self.qkv, AdaptedLinear):  # W8A8
            # head-major int8 product -> attention writing the dense [B, N, C]
            # rows -> one-pass quantize (K4c) -> int8 proj
            qkv = self.qkv(x)  # [B, 3H, N, D], a view
            out = fused_qkv_attention(qkv, h, h, causal=False, kv_valid=kv_valid,
                                      out_layout="bsd")
            return self.proj(quant_fuse.quant_rows(out) if self.quant_rows else out)
        b, n, _ = x.shape
        # [B, N, 3H, D] viewed head-major as [B, 3H, N, D]: the kernel reads
        # q/k/v through the strides, no copy
        qkv = self.qkv(x).view(b, n, 3 * h, d).transpose(1, 2)
        out = fused_qkv_attention(qkv, h, h, causal=False, kv_valid=kv_valid)
        return self.proj(out.transpose(1, 2).reshape(b, n, h * d))


class InternMLP(nn.Module):
    """Split over `tensor`: `fc1` by columns, `fc2` by rows."""

    TENSOR_ROLES = {"fc1": COLUMN, "fc2": ROW}

    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        precision = tower_precision(precision)
        self.approximate = "tanh" if config.approximate_gelu else "none"
        adapted = lora is not None and lora.r > 0
        # the fused feeds (K4a into the projections' norms, K4b into fc2),
        # off where an adapter reads the float activation
        self.fuse = precision.w8a8 and "vit" in precision.fuse_quant and not adapted
        c, f = config.hidden_size, config.intermediate_size
        self.fc1 = make_linear(c, f, lora=lora, precision=precision)
        self.fc2 = make_linear(f, c, lora=lora, precision=precision)

    def tensor_divides(self, size: int) -> bool:
        return True  # JAX's guard decides on the intermediate width

    def split_(self, split) -> None:
        self.fc1 = split_linear(self.fc1, COLUMN, split)
        self.fc2 = split_linear(self.fc2, ROW, split)

    def forward(self, x) -> torch.Tensor:
        """x: [B, N, C], or under W8A8 its (int8, scale) rows."""
        if self.fuse and self.approximate == "tanh":
            # fused tanh-GELU + quantize (K4b) of fc1's output
            return self.fc2(quant_fuse.gelu_quant(self.fc1(x)))
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class InternVisionEncoderLayer(nn.Module):
    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None, drop_path_rate: float = 0.0):
        super().__init__()
        c = config.hidden_size
        self.initializer_factor = config.initializer_factor
        self.drop_path_rate = drop_path_rate
        self.generator: Optional[torch.Generator] = None  # models/lora.set_generator
        self.ls1 = nn.Parameter(torch.full((c,), config.initializer_factor))
        self.ls2 = nn.Parameter(torch.full((c,), config.initializer_factor))
        self.norm1 = make_norm(config.norm_type, c, config.layer_norm_eps)
        self.attn = InternAttention(config, precision, lora)
        self.norm2 = make_norm(config.norm_type, c, config.layer_norm_eps)
        self.mlp = InternMLP(config, precision, lora)
        self.fuse = self.mlp.fuse

    def _feed(self, norm: nn.Module, x: torch.Tensor):
        """The norm's output; under W8A8 with "vit" in `fuse_quant` and a
        LayerNorm, its int8 rows and scales from the fused kernel (K4a). An
        RMSNorm feed stays unfused and the projection quantizes it, as in the
        JAX layer."""
        if self.fuse and isinstance(norm, LayerNorm):
            return quant_fuse.layernorm_quant(x, norm.weight, norm.bias, norm.eps)
        return norm(x)

    def _drop_path(self, branch: torch.Tensor) -> torch.Tensor:
        """Stochastic depth: in training, drop the whole residual branch per
        sample and scale the kept ones by 1 / keep."""
        if not self.training or self.drop_path_rate == 0.0:
            return branch
        if self.generator is None:
            raise RuntimeError("drop path in training needs a generator: call "
                               "models/lora.set_generator first")
        keep = 1.0 - self.drop_path_rate
        mask = torch.empty(
            (branch.shape[0],) + (1,) * (branch.ndim - 1), dtype=branch.dtype,
            device=branch.device,
        ).bernoulli_(keep, generator=self.generator)
        return (branch / keep) * mask

    def forward(self, x: torch.Tensor, kv_valid: int | None = None) -> torch.Tensor:
        attn_out = self.attn(self._feed(self.norm1, x), kv_valid)
        x = x + self._drop_path(attn_out * self.ls1.to(attn_out.dtype))
        mlp_out = self.mlp(self._feed(self.norm2, x))
        return x + self._drop_path(mlp_out * self.ls2.to(mlp_out.dtype))


class InternVisionModel(nn.Module):
    """Full encoder: [B, H, W, 3] -> the hidden state at `select_layer`
    [B, 1 + P, C] (the last by default).

    `remat_policy` (with `grad_checkpoint`): a JAX checkpoint policy's name,
    e.g. 'dots_with_no_batch_dims_saveable', that picks what each layer
    saves for its backward (`ops/remat.policy_fn`); None recomputes whole
    layers. The JAX model applies it to this tower alone, as here."""

    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None, grad_checkpoint: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.config = config
        self.grad_checkpoint = grad_checkpoint
        self.remat_policy = remat_policy if grad_checkpoint and remat_policy else None
        if self.remat_policy:
            policy_fn(self.remat_policy)  # an unknown name raises at the build
        self.generator: Optional[torch.Generator] = None  # models/lora.set_generator
        self.embeddings = InternVisionEmbeddings(config)
        n = config.num_hidden_layers
        # stochastic-depth rates: linspace(0, drop_path_rate, L)
        rates = [config.drop_path_rate * i / (n - 1) for i in range(n)] if n > 1 else [
            config.drop_path_rate]
        self.layers = nn.ModuleList(
            InternVisionEncoderLayer(config, precision, lora, rates[i]) for i in range(n)
        )

    def forward(self, pixel_values: torch.Tensor, select_layer: int = -1) -> torch.Tensor:
        n_layers = len(self.layers)
        # hidden_states[select_layer] is the input of layer select_layer % (L + 1)
        n_run = n_layers if select_layer == -1 else select_layer % (n_layers + 1)
        x = self.embeddings(pixel_values)
        # pad the token axis once for the whole encoder (1025 -> 1032), as
        # the JAX encoder does for its kernel's 8-row tiles; the pad rows are
        # masked as keys and cut off at the end
        n_tok = x.shape[1]
        n_pad = (-n_tok) % 8
        kv_valid = n_tok if n_pad else None
        if n_pad:
            x = F.pad(x, (0, 0, 0, n_pad))
        remat = self.grad_checkpoint and torch.is_grad_enabled()
        for layer in self.layers[:n_run]:
            if remat:
                x = checkpoint_layer(layer, self.generator, x, kv_valid,
                                     policy=self.remat_policy)
            else:
                x = layer(x, kv_valid)
        return x[:, :n_tok]
