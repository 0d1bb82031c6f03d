"""InternViT vision encoder (`aigv_assessor_tpu/models/vit.py`): InternViT-300M
(InternVL2-2B) and InternViT-6B (InternVL2-26B).

Patch embedding (14x14 conv, stride 14), class token, learned position
embedding, then pre-norm layers with LayerScale: attention off one fused qkv
projection through the flash-attention kernel, and a tanh-GELU MLP.

With `qk_normalization` (InternViT-6B: RMSNorm layers, no qkv bias) the
layer follows the JAX layer's other branch (`models/vit.py:199-226`): `qkv`
is a plain [B, N, 3C] projection; q and k go through `q_norm` / `k_norm`, an
RMSNorm over the flattened C; the three [B, N, H, D] tensors go to
`multi_head_attention` (the three-tensor kernel K2 in `bshd`, and in
training its logsumexp form and backward); `proj` is a plain projection.

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

Training (`lora` set, `module.train()`): the four projections are
`LoRALinear`s, `qkv` head-major out and `proj` head-major in, so attention
stays on the fused-qkv kernel and its backward kernels (with
`qk_normalization`, plain projections around the three-tensor kernel and
its backward kernels); each residual branch
is dropped per sample with rates linspace(0, drop_path_rate, L) (stochastic
depth); with `grad_checkpoint` each layer's activations are recomputed in
the backward (`ops/remat.py`). In `eval()` the layers are deterministic.

Not ported yet (ROADMAP.md, Queue 1): position-embedding interpolation for
another input size, `select_layer` other than -1, LoRA over a W8A8 base, a
QK-normalized tower under W8A8, int8 or int4.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LoRAConfig, VisionConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.lora import (
    LoRALinear,
    W8A8Linear,
    make_linear,
    reject_quantized_lora,
)
from aigv_assessor_torch.ops import quant_fuse
from aigv_assessor_torch.ops.attention import fused_qkv_attention, multi_head_attention
from aigv_assessor_torch.ops.norms import LayerNorm, RMSNorm
from aigv_assessor_torch.ops.remat import checkpoint_layer


def make_norm(norm_type: str, dim: int, eps: float) -> nn.Module:
    return RMSNorm(dim, eps) if norm_type == "rms_norm" else LayerNorm(dim, eps)


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
        if (h, w) != (cfg.num_patches_per_side,) * 2:
            raise NotImplementedError(
                f"{h}x{w} patch grid, position embeddings are "
                f"{cfg.num_patches_per_side}x{cfg.num_patches_per_side}: "
                "position-embedding interpolation is not ported yet "
                "(ROADMAP.md, Queue 1)"
            )
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, C], row-major over (h, w)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.to(x.dtype)


class InternAttention(nn.Module):
    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        reject_quantized_lora(precision, lora)
        self.num_heads = h = config.num_attention_heads
        self.qk_normalization = config.qk_normalization
        self.w8a8 = precision.w8a8
        self.quant_rows = precision.w8a8 and "vit" in precision.quant_rows
        c = config.hidden_size
        if self.qk_normalization:
            if precision.w8a8 or precision.weight_only:
                raise NotImplementedError(
                    "a QK-normalized ViT under W8A8, int8 or int4 is not ported yet "
                    "(ROADMAP.md, Queue 1 item 2)"
                )
            self.qkv = make_linear(c, 3 * c, bias=config.qkv_bias, lora=lora)
            self.q_norm = RMSNorm(c, config.layer_norm_eps)
            self.k_norm = RMSNorm(c, config.layer_norm_eps)
            self.proj = make_linear(c, c, lora=lora)
        elif self.w8a8:
            dt = precision.compute_dtype
            self.qkv = W8A8Linear(c, 3 * c, bias=config.qkv_bias, out_dtype=dt, heads=3 * h)
            self.proj = W8A8Linear(c, c, out_dtype=dt)
        else:
            self.qkv = make_linear(c, 3 * c, bias=config.qkv_bias, lora=lora, heads=3 * h)
            self.proj = make_linear(c, c, lora=lora, head_major_in=True)

    def forward(self, x, kv_valid: int | None = None) -> torch.Tensor:
        """x: [B, N, C], or under W8A8 its (int8, scale) rows."""
        h = self.num_heads
        if self.qk_normalization:
            b, n, c = x.shape
            q, k, v = self.qkv(x).split(c, dim=-1)  # each [B, N, C]; v a strided view
            q = self.q_norm(q).view(b, n, h, c // h)
            k = self.k_norm(k).view(b, n, h, c // h)
            out = multi_head_attention(q, k, v.view(b, n, h, c // h), causal=False,
                                       kv_valid=kv_valid)  # [B, N, H, D]
            return self.proj(out.reshape(b, n, c))
        if isinstance(self.qkv, LoRALinear):
            # head-major out -> attention -> head-major in: [B, 3H, N, D] ->
            # [B, H, N, D] -> [B, N, C]
            out = fused_qkv_attention(self.qkv(x), h, h, causal=False, kv_valid=kv_valid)
            return self.proj(out)
        if self.w8a8:
            # head-major int8 product -> attention writing the dense [B, N, C]
            # rows -> one-pass quantize (K4c) -> int8 proj
            qkv = self.qkv(x)  # [B, 3H, N, D], a view
            out = fused_qkv_attention(qkv, h, h, causal=False, kv_valid=kv_valid,
                                      out_layout="bsd")
            return self.proj(quant_fuse.quant_rows(out) if self.quant_rows else out)
        b, n, c = x.shape
        # [B, N, 3H, D] viewed head-major as [B, 3H, N, D]: the kernel reads
        # q/k/v through the strides, no copy
        qkv = self.qkv(x).view(b, n, 3 * h, c // h).transpose(1, 2)
        out = fused_qkv_attention(qkv, h, h, causal=False, kv_valid=kv_valid)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class InternMLP(nn.Module):
    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        reject_quantized_lora(precision, lora)
        self.approximate = "tanh" if config.approximate_gelu else "none"
        self.w8a8 = precision.w8a8
        self.fuse = precision.w8a8 and "vit" in precision.fuse_quant
        c, f = config.hidden_size, config.intermediate_size
        if self.w8a8:
            self.fc1 = W8A8Linear(c, f, out_dtype=precision.compute_dtype)
            self.fc2 = W8A8Linear(f, c, out_dtype=precision.compute_dtype)
        else:
            self.fc1 = make_linear(c, f, lora=lora)
            self.fc2 = make_linear(f, c, lora=lora)

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
        self.fuse = precision.w8a8 and "vit" in precision.fuse_quant
        self.drop_path_rate = drop_path_rate
        self.generator: Optional[torch.Generator] = None  # models/lora.set_generator
        self.ls1 = nn.Parameter(torch.full((c,), config.initializer_factor))
        self.ls2 = nn.Parameter(torch.full((c,), config.initializer_factor))
        self.norm1 = make_norm(config.norm_type, c, config.layer_norm_eps)
        self.attn = InternAttention(config, precision, lora)
        self.norm2 = make_norm(config.norm_type, c, config.layer_norm_eps)
        self.mlp = InternMLP(config, precision, lora)

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
    """Full encoder: [B, H, W, 3] -> last hidden state [B, 1 + P, C]."""

    def __init__(self, config: VisionConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None, grad_checkpoint: bool = False):
        super().__init__()
        self.config = config
        self.grad_checkpoint = grad_checkpoint
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
        if select_layer != -1:
            raise NotImplementedError(
                "partial-depth ViT features (select_layer != -1) are not "
                "ported yet (ROADMAP.md, Queue 1)"
            )
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
        for layer in self.layers:
            if remat:
                x = checkpoint_layer(layer, self.generator, x, kv_valid)
            else:
                x = layer(x, kv_valid)
        return x[:, :n_tok]
