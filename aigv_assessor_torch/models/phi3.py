"""Phi-3 decoder (`aigv_assessor_tpu/models/phi3.py`), InternVL2-4B's
language model: the InternLM2 decoder's machinery under Phi-3's parameter
names and with its own RoPE.

- `qkv_proj`: one fused projection whose outputs are the plain concatenation
  [q heads | k heads | v heads], no bias; `o_proj`, no bias.
- `gate_up_proj`: one fused projection [gate | up]; silu(gate) * up goes
  through `down_proj`.
- RMSNorm `input_layernorm` / `post_attention_layernorm` / `norm`, an untied
  `lm_head`.
- RoPE with 'su' / 'longrope' scaling (`phi3_rope_tables`): the inverse
  frequencies divided by the short factor table, or by the long one when the
  table is longer than `original_max_position_embeddings`, and both cos and
  sin multiplied by sqrt(1 + log(s) / log(original)), s = max / original.

Everything else is the InternLM2 module's (`models/internlm2.py`): the
cache-free head-major branch on the fused-qkv attention kernel, the row-major
branch with a cache or under the weight-only modes, the KV cache and its
in-place writes, the single-token steps on the decode kernel, `capture_kv` and
`block_causal` for the shared prefix, and per-layer recompute in training.

Precisions, as in JAX (`aigv_assessor_tpu/models/phi3.py:146-203`,
`aigv_assessor_tpu/models/loading.py:136-146`):

- W8A8: `qkv_proj`, `gate_up_proj` and `down_proj` are `W8A8Linear`s;
  `o_proj` stays float and reads the attention's head-major output. With
  "llm" in `Precision.fuse_quant` the two norms feed their projections
  through the fused RMSNorm + quantize kernel (K5a) and silu(gate) * up
  reaches `down_proj` through the fused SwiGLU + quantize kernel (K5b); both
  are off under adapters.
- int8 / int4 weights: the four projections are `Int8Linear` / `Int4Linear`
  on the row-major branch (K6 / K7 matmuls, K2 attention on three tensors).
  `lm_head` stays a float `nn.Linear` in every precision, as JAX's
  `nn.Dense`; JAX's weight-only trees quantize it all the same, so JAX cannot
  compute logits there (`apply(..., with_logits=True)` finds no `kernel`
  under `lm_head`). Asking this module for logits under a weight-only mode
  raises ValueError; scoring (`with_logits=False`) runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LoRAConfig, Phi3Config
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.internlm2 import (
    CausalDecoder,
    InternLM2Attention,
    InternLM2DecoderLayer,
)
from aigv_assessor_torch.models.lora import make_linear
from aigv_assessor_torch.ops import quant_fuse
from aigv_assessor_torch.ops.norms import RMSNorm


def phi3_rope_tables(cfg: Phi3Config, seq_len: int,
                     device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[seq_len, D] fp32 cos / sin with the su / longrope factor tables and
    attention scaling, built in numpy fp32 exactly as the JAX package builds
    them."""
    dim = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    scale_mult = 1.0
    if cfg.rope_scaling_type in ("su", "longrope"):
        if seq_len > cfg.original_max_position_embeddings and cfg.rope_long_factor:
            factors = np.asarray(cfg.rope_long_factor, np.float32)
        elif cfg.rope_short_factor:
            factors = np.asarray(cfg.rope_short_factor, np.float32)
        else:
            factors = np.ones_like(inv_freq)
        inv_freq = inv_freq / factors
        scale = cfg.max_position_embeddings / cfg.original_max_position_embeddings
        if scale > 1.0:
            scale_mult = float(np.sqrt(
                1.0 + np.log(scale) / np.log(cfg.original_max_position_embeddings)))
    t = np.arange(seq_len, dtype=np.float32)
    emb = np.concatenate([np.outer(t, inv_freq)] * 2, axis=-1)
    cos = torch.from_numpy((np.cos(emb) * scale_mult).astype(np.float32)).to(device)
    sin = torch.from_numpy((np.sin(emb) * scale_mult).astype(np.float32)).to(device)
    return cos, sin


class Phi3Attention(InternLM2Attention):
    """`qkv_proj` / `o_proj`, no biases; `o_proj` float under W8A8. Never
    split over `tensor`: JAX's rule table names none of Phi-3's projections,
    so GSPMD replicates them over the axis."""

    QKV, OUT = "qkv_proj", "o_proj"
    TENSOR_ROLES: dict = {}

    def _biases(self, config) -> Tuple[bool, bool]:
        return False, False

    def _out_precision(self, precision: Precision) -> Precision:
        return dataclasses.replace(precision, w8a8=False)


class Phi3MLP(nn.Module):
    """silu(gate) * up -> `down_proj`, gate and up off one `gate_up_proj`."""

    def __init__(self, config: Phi3Config, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        c, f = config.hidden_size, config.intermediate_size
        adapted = lora is not None and lora.r > 0
        self.fuse = precision.w8a8 and "llm" in precision.fuse_quant and not adapted
        self.gate_up_proj = make_linear(c, 2 * f, bias=False, lora=lora, precision=precision)
        self.down_proj = make_linear(f, c, bias=False, lora=lora, precision=precision)

    def forward(self, x):
        """x: [B, S, C], or under fused W8A8 feeds its (int8, scale) rows."""
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        if self.fuse:  # the kernel (K5b) reads whole rows: the halves copied out
            return self.down_proj(quant_fuse.silu_mul_quant(gate.contiguous(), up.contiguous()))
        return self.down_proj(F.silu(gate) * up)


class Phi3DecoderLayer(InternLM2DecoderLayer):
    NAMES = ("input_layernorm", "self_attn", "post_attention_layernorm", "mlp")
    ATTENTION, MLP = Phi3Attention, Phi3MLP


class Phi3ForCausalLM(CausalDecoder):
    """The (logits, hidden, cache) interface of `InternLM2ForCausalLM`, so the
    composite model takes either."""

    def __init__(self, config: Phi3Config, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None, grad_checkpoint: bool = False):
        super().__init__(config, precision, grad_checkpoint)
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            Phi3DecoderLayer(config, precision, lora) for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def _build_rope(self, rope_len: int, device: torch.device):
        return phi3_rope_tables(self.config, rope_len, device)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.precision.weight_only:
            raise ValueError(
                "Phi-3 under int8 / int4 weights has no logits: the JAX package quantizes "
                "lm_head but runs it as a float Dense, so it fails there too; score with "
                "with_logits=False")
        return self.lm_head(hidden).to(self.precision.logits_dtype)

