"""InternLM2 decoder (`aigv_assessor_tpu/models/internlm2.py`), the
cache-free forward that scoring and training run.

GQA attention off one fused `wqkv` projection whose output heads are
ordered [q heads | k heads | v heads] (the JAX checkpoint converter
de-interleaves the reference's layout once; this port takes that order),
RoPE with dynamic-NTK scaling, causal flash attention, SwiGLU feed-forward,
RMSNorm. The untied LM head `output` is part of the weights but the scoring
forward does not run it.

Attention applies the causal mask only, as the JAX fast path does: right
padding needs no key mask because pad keys are only attended by pad
queries, whose outputs are never read.

Under W8A8 (`Precision.w8a8`) the five projections are `W8A8Linear`s with
unfused feeds, the JAX decoder's default
(`aigv_assessor_tpu/models/internlm2.py:143-212`, `:293-327`): each norm
returns the compute dtype and the projection quantizes it with the plain
`quantize_rows`; the attention kernel writes the dense `bsd` rows that `wo`
quantizes the same way; w1 and w3 share one quantization of their common
input, bit for bit what quantizing it twice gives. The LM head stays float.

Under the weight-only modes (`Precision.int8_weights`, `int4_weights`) the
decoder takes the JAX decoder's row-major branch (`:215-284`, `:295-327`):
the five projections and the LM head are `Int8Linear` / `Int4Linear`s; q, k
and v are [B, S, H, D] views of the one projection output; RoPE runs in that
layout and attention is `multi_head_attention` on the three tensors, whose
[B, S, Hq, D] output reshapes into `wo`'s input without a copy.

Training (`lora` set): the five projections are `LoRALinear`s, `wqkv`
head-major out and `wo` head-major in, so attention stays on the fused-qkv
kernel and its backward kernels; with `grad_checkpoint` each layer's
activations are recomputed in the backward (`ops/remat.py`).

Not ported yet (ROADMAP.md, Queue 1): the KV cache and decoding, the
logits path, LoRA over a quantized base, tied embeddings.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LLMConfig, LoRAConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.lora import (
    LoRALinear,
    W8A8Linear,
    make_linear,
    reject_quantized_lora,
    weight_only_linear,
)
from aigv_assessor_torch.ops.attention import fused_qkv_attention, multi_head_attention
from aigv_assessor_torch.ops.norms import RMSNorm
from aigv_assessor_torch.ops.remat import checkpoint_layer
from aigv_assessor_torch.ops.rope import apply_rope, rope_cos_sin
from aigv_assessor_torch.ops.w8a8 import quantize_rows


class InternLM2Attention(nn.Module):
    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        reject_quantized_lora(precision, lora)
        self.hq = hq = config.num_attention_heads
        self.hkv = hkv = config.num_key_value_heads
        self.head_dim = d = config.head_dim
        self.w8a8 = precision.w8a8
        self.weight_only = precision.weight_only
        c = config.hidden_size
        dt = precision.compute_dtype
        if self.weight_only:
            linear = weight_only_linear(precision)
            self.wqkv = linear(c, (hq + 2 * hkv) * d, bias=config.effective_qkv_bias,
                               out_dtype=dt)
            self.wo = linear(hq * d, c, bias=config.effective_o_bias, out_dtype=dt)
        elif self.w8a8:
            self.wqkv = W8A8Linear(c, (hq + 2 * hkv) * d, bias=config.effective_qkv_bias,
                                   out_dtype=dt, heads=hq + 2 * hkv)
            self.wo = W8A8Linear(hq * d, c, bias=config.effective_o_bias, out_dtype=dt)
        else:
            self.wqkv = make_linear(c, (hq + 2 * hkv) * d, bias=config.effective_qkv_bias,
                                    lora=lora, heads=hq + 2 * hkv)
            self.wo = make_linear(hq * d, c, bias=config.effective_o_bias, lora=lora,
                                  head_major_in=True)

    def forward(self, x, cos, sin, position_ids):
        b, s, _ = x.shape
        hq, hkv, d = self.hq, self.hkv, self.head_dim
        if self.weight_only:
            qkv = self.wqkv(x)  # [B, S, (Hq + 2*Hkv)*D]; q, k, v are views of it
            q = qkv[..., : hq * d].view(b, s, hq, d)
            k = qkv[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
            v = qkv[..., (hq + hkv) * d :].view(b, s, hkv, d)
            q, k = apply_rope(q, k, cos, sin, position_ids, layout="bshd")
            out = multi_head_attention(q, k, v, causal=True)  # [B, S, Hq, D]
            return self.wo(out.reshape(b, s, hq * d))
        if self.w8a8 or isinstance(self.wqkv, LoRALinear):
            qkv = self.wqkv(x)  # [B, H, S, D], a view of the dense product
        else:
            qkv = self.wqkv(x).view(b, s, hq + 2 * hkv, d).transpose(1, 2)
        q, k = apply_rope(qkv[:, :hq], qkv[:, hq : hq + hkv], cos, sin, position_ids)
        # re-fuse after rope so the kernel reads q/k/v from one array
        qkv = torch.cat([q, k, qkv[:, hq + hkv :]], dim=1)
        if self.w8a8:
            # the kernel writes wo's dense [B, S, Hq*D] input rows
            return self.wo(fused_qkv_attention(qkv, hq, hkv, causal=True, out_layout="bsd"))
        out = fused_qkv_attention(qkv, hq, hkv, causal=True)  # [B, Hq, S, D]
        if isinstance(self.wo, LoRALinear):
            return self.wo(out)  # head-major in
        return self.wo(out.transpose(1, 2).reshape(b, s, hq * d))


class InternLM2MLP(nn.Module):
    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        reject_quantized_lora(precision, lora)
        c, f = config.hidden_size, config.intermediate_size
        self.w8a8 = precision.w8a8
        dt = precision.compute_dtype
        if precision.weight_only:
            linear = weight_only_linear(precision)
            self.w1 = linear(c, f, bias=False, out_dtype=dt)
            self.w3 = linear(c, f, bias=False, out_dtype=dt)
            self.w2 = linear(f, c, bias=False, out_dtype=dt)
        elif self.w8a8:
            self.w1 = W8A8Linear(c, f, bias=False, out_dtype=dt)
            self.w3 = W8A8Linear(c, f, bias=False, out_dtype=dt)
            self.w2 = W8A8Linear(f, c, bias=False, out_dtype=dt)
        else:
            self.w1 = make_linear(c, f, bias=False, lora=lora)
            self.w3 = make_linear(c, f, bias=False, lora=lora)
            self.w2 = make_linear(f, c, bias=False, lora=lora)

    def forward(self, x):
        if self.w8a8:
            x = quantize_rows(x)  # one quantization feeds both w1 and w3
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class InternLM2DecoderLayer(nn.Module):
    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.attention_norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.attention = InternLM2Attention(config, precision, lora)
        self.ffn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.feed_forward = InternLM2MLP(config, precision, lora)

    def forward(self, x, cos, sin, position_ids):
        x = x + self.attention(self.attention_norm(x), cos, sin, position_ids)
        return x + self.feed_forward(self.ffn_norm(x))


class InternLM2ForCausalLM(nn.Module):
    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None, grad_checkpoint: bool = False):
        super().__init__()
        if config.tie_word_embeddings:
            raise NotImplementedError(
                "tied embeddings are not ported yet (ROADMAP.md, Queue 1)"
            )
        self.config = config
        self.grad_checkpoint = grad_checkpoint
        self.generator: Optional[torch.Generator] = None  # models/lora.set_generator
        self.tok_embeddings = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            InternLM2DecoderLayer(config, precision, lora)
            for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        if precision.weight_only:
            self.output = weight_only_linear(precision)(
                config.hidden_size, config.vocab_size, bias=False,
                out_dtype=precision.compute_dtype)
        else:
            self.output = nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.tok_embeddings(input_ids)

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        """[B, S, C] embeddings at positions 0..S-1 -> final hidden state
        (after the last norm), [B, S, C]."""
        cfg = self.config
        b, s, _ = inputs_embeds.shape
        device = inputs_embeds.device
        position_ids = torch.arange(s, device=device).expand(b, s)
        rs = cfg.rope_scaling
        cos, sin = rope_cos_sin(
            s,
            cfg.head_dim,
            base=cfg.rope_theta,
            scaling_type=rs.type if rs else None,
            scaling_factor=rs.factor if rs else 1.0,
            max_position_embeddings=cfg.max_position_embeddings,
            device=device,
        )
        x = inputs_embeds.to(self.norm.weight.dtype)
        remat = self.grad_checkpoint and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint_layer(layer, self.generator, x, cos, sin, position_ids)
            else:
                x = layer(x, cos, sin, position_ids)
        return self.norm(x)
