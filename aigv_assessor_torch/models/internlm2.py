"""InternLM2 decoder (`aigv_assessor_tpu/models/internlm2.py`): the
cache-free forward that scoring and training run, and the forward against a
fixed-capacity KV cache that generation and shared-prefix scoring run.

GQA attention off one fused `wqkv` projection whose output heads are
ordered [q heads | k heads | v heads] (the JAX checkpoint converter
de-interleaves the reference's layout once; this port takes that order),
RoPE with dynamic-NTK scaling, causal flash attention, SwiGLU feed-forward,
RMSNorm. The untied LM head `output` gives the logits (`with_logits`, in
`Precision.logits_dtype`, fp32 by default) over every position; the stage-2
scoring and training forwards leave it out, stage 1 reads it through
`cross_entropy_loss`.

Attention applies the causal mask only, as the JAX fast path does: right
padding needs no key mask because pad keys are only attended by pad
queries, whose outputs are never read.

Under W8A8 (`Precision.w8a8`) the five projections are `W8A8Linear`s. By
default their feeds are unfused, the JAX decoder's default
(`aigv_assessor_tpu/models/internlm2.py:143-212`, `:293-327`): each norm
returns the compute dtype and the projection quantizes it with the plain
`quantize_rows`; the attention kernel writes the dense `bsd` rows that `wo`
quantizes the same way; w1 and w3 share one quantization of their common
input, bit for bit what quantizing it twice gives. With "llm" in
`Precision.fuse_quant` (JAX's `AIGV_FUSE_QUANT=llm`, `:50-58`, `:309-320`,
`:352-383`) attention_norm and ffn_norm emit the (int8, scale) pair through
the fused RMSNorm + quantize kernel (K5a), w1 and w3 share that pair, and
silu(w1) * w3 reaches w2 through the fused SwiGLU + quantize kernel (K5b);
the pair flows through both branches below, the cache-free one and the
row-major one with a cache. With "llm" in `Precision.quant_rows` (JAX's
`AIGV_QUANT_ROWS=llm`, `:195-203`) the attention kernel's `bsd` rows go
through the one-pass quantize (K4c) into `wo`, on the cache-free branch
only. K5a multiplies the norm weight in fp32 where the unfused norm rounds
the normalized x to the compute dtype first (`ops/norms.rms_norm`), so the
two configurations give other int8 values, not only other speeds. The LM
head stays float.

Under the weight-only modes (`Precision.int8_weights`, `int4_weights`) the
decoder takes the JAX decoder's row-major branch (`:215-284`, `:295-327`):
the five projections and the LM head are `Int8Linear` / `Int4Linear`s; q, k
and v are [B, S, H, D] views of the one projection output; RoPE runs in that
layout and attention is `multi_head_attention` on the three tensors, whose
[B, S, Hq, D] output reshapes into `wo`'s input without a copy.

Adapters (`lora` set): the five projections carry them over any base
(`models/lora.make_linear`): float `LoRALinear`s in training, `wqkv`
head-major out and `wo` head-major in, so attention stays on the fused-qkv
kernel and its backward kernels, with `grad_checkpoint` each layer's
activations recomputed in the backward (`ops/remat.py`); in evaluation also
over W8A8, int8 or int4 bases, as the JAX decoder runs `LoRADense(w8a8 |
int8 | int4, lora=...)`. The delta reads the float activation, so under
adapters every fused quantize feed (K5a, K5b, K4c) is off and w1 and w3
each quantize their input, as in JAX (`:197`, `:313`, `:358`).

With a cache (`KVCache`) every precision takes the row-major branch, as in
JAX: `wqkv` and `wo` are applied in their row-major form (the same weights
and adapters; bf16 and W8A8 hold them for head-major use), the block of new
tokens attends (old cache rows) + (itself) in one softmax, and the layer
loop writes the block's roped k/v rows into the cache in place. A single new token on a
float cache goes through the decode-attention kernel
(`ops/decode_attention.py`: the window and the token itself in one launch)
whenever the head shape passes `decode_kernel_supported`, with each
sample's first attended row computed once per step for all layers; a longer
block, `block_causal` or an int8 cache
goes through `ops/attention.two_part_cached_attention`. Without a cache,
`capture_kv` hands back every layer's roped k/v in cache layout, which the
shared-prefix scorer turns into a cache.

Tied embeddings (`tie_word_embeddings`, Qwen2-0.5B's config): there is no
`output`; the logits are the final hidden state times the embedding matrix,
both in the compute dtype (JAX's `Embed.attend`), cast to `logits_dtype`. The
embedding is never quantized, so this holds in every precision.

Llama and Qwen2 checkpoints run this decoder (`LLMConfig.from_dict` gives
their biases). `InternLM2ForSequenceClassification` pools the last
non-padding token's hidden state into a bias-free `score` layer.

Over the `tensor` mesh axis (`parallel/tensor.py`, `split_`) a float
decoder holds this rank's kv groups: `wqkv` keeps their q, k and v heads,
`wo` the matching input features, `w1` / `w3` a share of their output
features, `w2` the matching input features; `hq` / `hkv` are local, so are the KV cache's heads
(`CausalDecoder.kv_heads`), and the embeddings, norms and LM head stay
whole. Llama and Qwen2 split the same way; Phi-3 never does.

The layer loop, the rope-table cache, the KV cache's writes and the
single-token steps' `starts` live in `CausalDecoder`, which the Phi-3
decoder (`models/phi3.py`) shares; its attention, MLP and layer subclass the
ones here under its own parameter names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import LLMConfig, LoRAConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.lora import (
    AdaptedLinear,
    LoRALinear,
    make_linear,
    weight_only_linear,
)
from aigv_assessor_torch.ops.attention import (
    fused_qkv_attention,
    multi_head_attention,
    two_part_cached_attention,
)
from aigv_assessor_torch.ops.decode_attention import (
    cached_decode_attention,
    decode_kernel_supported,
    window_starts,
)
from aigv_assessor_torch.ops.kv_quant import is_quantized, make_cache_rows
from aigv_assessor_torch.ops.norms import RMSNorm
from aigv_assessor_torch.ops.remat import checkpoint_layer
from aigv_assessor_torch.ops.rope import apply_rope, rope_cos_sin
from aigv_assessor_torch.ops import quant_fuse
from aigv_assessor_torch.ops.w8a8 import quantize_rows
from aigv_assessor_torch.parallel.tensor import COLUMN, ROW, split_linear


@dataclass
class KVCache:
    """Fixed-capacity KV cache, stacked over layers.

    `k` and `v` are [L, B, max_len, Hkv, D] tensors, or under
    `Precision.kv_int8` `(int8 [L, B, max_len, Hkv, D], fp32 [L, B, max_len,
    Hkv])` pairs (`ops/kv_quant.py`). The decoder writes new rows into them
    in place: a forward hands back a `KVCache` over the same storage with the
    index advanced, and the cache it was given must not be used again.

    Where the index lives. `index`, the number of filled positions, is a
    Python int on the host: slices, masks and the rope positions are made
    from it without asking the device. `index_dev` is the same number as an
    int32 scalar on the cache's device, which the decode-attention kernel
    reads as the end of its window; a forward advances it with a device add.
    So a decode step copies nothing between host and device for the index."""

    k: Any  # [L, B, max_len, Hkv, D], or (int8 data, fp32 scale [L, B, max_len, Hkv])
    v: Any
    index: int
    index_dev: torch.Tensor  # int32 scalar, equal to `index`

    @classmethod
    def init(cls, config: LLMConfig, batch: int, max_len: int,
             dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
             device: Optional[torch.device | str] = None,
             kv_heads: Optional[int] = None) -> "KVCache":
        """An empty cache; `kv_heads`: the kv heads a layer holds, the
        config's unless the decoder is split over `tensor`
        (`CausalDecoder.kv_heads`)."""
        shape = (config.num_hidden_layers, batch, max_len,
                 kv_heads or config.num_key_value_heads, config.head_dim)

        def kv():
            if quantized:
                return (torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.ones(shape[:-1], dtype=torch.float32, device=device))
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(k=kv(), v=kv(), index=0,
                   index_dev=torch.zeros((), dtype=torch.int32, device=device))

    @classmethod
    def from_prefix(cls, k: torch.Tensor, v: torch.Tensor, extra: int) -> "KVCache":
        """A cache whose first rows are the captured k/v of a prefix
        ([L, B, S, Hkv, D], `capture_kv`), with room for `extra` more."""
        s = k.shape[2]
        if extra:
            pad = (0, 0, 0, 0, 0, extra)
            k, v = F.pad(k, pad), F.pad(v, pad)
        return cls(k=k, v=v, index=s,
                   index_dev=torch.full((), s, dtype=torch.int32, device=k.device))

    @property
    def max_len(self) -> int:
        return (self.k[0] if is_quantized(self.k) else self.k).shape[2]


def _layer_slot(part, i: int):
    """Layer i of a stacked cache part (a tensor or an (int8, scale) pair)."""
    return tuple(t[i] for t in part) if is_quantized(part) else part[i]


def _write_rows(part, new, i: int, at: int) -> None:
    """Write a layer's new rows into the stacked cache part in place at
    [i, :, at : at + s]: data [B, s, Hkv, D] and, for an int8 cache, scales
    [B, s, Hkv] alike."""
    if is_quantized(part):
        for t, n in zip(part, new):
            t[i, :, at : at + n.shape[1]] = n
    else:
        part[i, :, at : at + new.shape[1]] = new


class InternLM2Attention(nn.Module):
    """GQA attention off one fused qkv projection (`QKV`) into the output
    projection (`OUT`); the Phi-3 attention is this one under its own names
    with a float output projection under W8A8.

    Split over `tensor` (`split_`), `hq` / `hkv` are this rank's: `wqkv`
    keeps its kv groups' q, k and v heads, `wo` the matching input columns,
    and a single-token step takes the decode kernel where the local head
    shape passes `decode_kernel_supported`."""

    QKV, OUT = "wqkv", "wo"
    TENSOR_ROLES = {"wqkv": COLUMN, "wo": ROW}

    def _biases(self, config) -> Tuple[bool, bool]:
        """(qkv bias, out bias)."""
        return config.effective_qkv_bias, config.effective_o_bias

    def _out_precision(self, precision: Precision) -> Precision:
        """The output projection's precision: W8A8 like the rest here."""
        return precision

    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.hq = hq = config.num_attention_heads
        self.hkv = hkv = config.num_key_value_heads
        self.head_dim = d = config.head_dim
        out_precision = self._out_precision(precision)
        self.weight_only = precision.weight_only
        # the output projection reads the kernel's dense `bsd` rows
        self.o_dense = out_precision.w8a8
        adapted = lora is not None and lora.r > 0
        self.quant_rows = self.o_dense and "llm" in precision.quant_rows and not adapted
        c = config.hidden_size
        qkv_bias, o_bias = self._biases(config)
        # weight-only: the row-major branch; else the qkv projection
        # head-major out, and the output projection dense under W8A8 (the
        # kernel writes its `bsd` rows), else head-major in
        setattr(self, self.QKV, make_linear(
            c, (hq + 2 * hkv) * d, bias=qkv_bias, lora=lora,
            heads=None if self.weight_only else hq + 2 * hkv, precision=precision))
        setattr(self, self.OUT, make_linear(
            hq * d, c, bias=o_bias, lora=lora,
            head_major_in=not (self.weight_only or self.o_dense), precision=out_precision))

    def tensor_divides(self, size: int) -> bool:
        return self.hkv % size == 0

    def split_(self, split) -> None:
        """Keep this rank's kv groups (`parallel/tensor.py`), in place."""
        hq, hkv, d = self.hq, self.hkv, self.head_dim
        setattr(self, self.QKV, split_linear(getattr(self, self.QKV), COLUMN, split,
                                             (hq * d, hkv * d, hkv * d)))
        setattr(self, self.OUT, split_linear(getattr(self, self.OUT), ROW, split))
        self.hq, self.hkv = hq // split.size, hkv // split.size

    def _project_rows(self, linear: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """`wqkv` or `wo` in its row-major form, [B, S, in] -> [B, S, out]:
        the same weight and adapter as the head-major form the cache-free
        paths use."""
        return linear.rows(x) if isinstance(linear, AdaptedLinear) else linear(x)

    def forward(self, x, cos, sin, position_ids, cache_k=None, cache_v=None,
                cache_index: Optional[int] = None,
                cache_index_dev: Optional[torch.Tensor] = None,
                kv_mask: Optional[torch.Tensor] = None, capture_kv: bool = False,
                block_causal: Optional[int] = None, starts: Optional[torch.Tensor] = None):
        """x: [B, S, C], or under fused W8A8 feeds its (int8, scale) rows.
        `starts` ([B] int32, `window_starts(kv_mask)`) serves a single-token
        step on the decode kernel; computed here if not given.
        -> (out [B, S, C], new rows). New rows: with a cache, the block's
        roped (k, v) as the cache stores them (`make_cache_rows`), for the
        caller to write at [cache_index, cache_index + S); without one, the
        roped (k, v) in cache layout [B, S, Hkv, D] if `capture_kv`, else
        None."""
        b, s, _ = (x[0] if isinstance(x, tuple) else x).shape
        hq, hkv, d = self.hq, self.hkv, self.head_dim
        wqkv, wo = getattr(self, self.QKV), getattr(self, self.OUT)
        if self.weight_only or cache_k is not None:
            # row-major: q, k, v are [B, S, H, D] views of one projection output
            qkv = self._project_rows(wqkv, x) if cache_k is not None else wqkv(x)
            q = qkv[..., : hq * d].view(b, s, hq, d)
            k = qkv[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
            v = qkv[..., (hq + hkv) * d :].view(b, s, hkv, d)
            q, k = apply_rope(q, k, cos, sin, position_ids, layout="bshd")
            if cache_k is None:
                new_rows = (k, v) if capture_kv else None
                out = multi_head_attention(q, k, v, causal=True)  # [B, S, Hq, D]
                return wo(out.reshape(b, s, hq * d)), new_rows
            new_rows = make_cache_rows(k, v, cache_k, cache_v)
            if (s == 1 and block_causal is None and not is_quantized(cache_k)
                    and decode_kernel_supported(hq, hkv, d)):
                out = cached_decode_attention(q, k, v, cache_k, cache_v, cache_index_dev,
                                              kv_mask, starts)
            else:
                out = two_part_cached_attention(q, k, v, cache_k, cache_v, cache_index,
                                                kv_mask, block_causal=block_causal)
            out = out.to(qkv.dtype).reshape(b, s, hq * d)  # the projection's dtype
            return self._project_rows(wo, out), new_rows
        if isinstance(wqkv, AdaptedLinear):
            qkv = wqkv(x)  # [B, H, S, D], a view of the dense product
        else:
            qkv = wqkv(x).view(b, s, hq + 2 * hkv, d).transpose(1, 2)
        q, k = apply_rope(qkv[:, :hq], qkv[:, hq : hq + hkv], cos, sin, position_ids)
        v = qkv[:, hq + hkv :]
        # the roped k/v in cache layout, for a caller that builds a cache of them
        new_rows = (k.transpose(1, 2), v.transpose(1, 2)) if capture_kv else None
        # re-fuse after rope so the kernel reads q/k/v from one array
        qkv = torch.cat([q, k, v], dim=1)
        if self.o_dense:
            # the kernel writes wo's dense [B, S, Hq*D] input rows
            out = fused_qkv_attention(qkv, hq, hkv, causal=True, out_layout="bsd")
            return wo(quant_fuse.quant_rows(out) if self.quant_rows else out), new_rows
        out = fused_qkv_attention(qkv, hq, hkv, causal=True)  # [B, Hq, S, D]
        if isinstance(wo, LoRALinear):
            return wo(out), new_rows  # head-major in
        return wo(out.transpose(1, 2).reshape(b, s, hq * d)), new_rows


class InternLM2MLP(nn.Module):
    """Split over `tensor`: `w1` / `w3` by columns, `w2` by rows."""

    TENSOR_ROLES = {"w1": COLUMN, "w3": COLUMN, "w2": ROW}

    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        c, f = config.hidden_size, config.intermediate_size
        adapted = lora is not None and lora.r > 0
        # one quantization of x feeds both w1 and w3, unless adapters read it
        self.share_quant = precision.w8a8 and not adapted
        self.fuse = precision.w8a8 and "llm" in precision.fuse_quant and not adapted
        self.w1 = make_linear(c, f, bias=False, lora=lora, precision=precision)
        self.w3 = make_linear(c, f, bias=False, lora=lora, precision=precision)
        self.w2 = make_linear(f, c, bias=False, lora=lora, precision=precision)

    def tensor_divides(self, size: int) -> bool:
        return True  # JAX's guard decides on the intermediate width

    def split_(self, split) -> None:
        for name, role in self.TENSOR_ROLES.items():
            setattr(self, name, split_linear(getattr(self, name), role, split))

    def forward(self, x):
        """x: [B, S, C], or under fused W8A8 feeds its (int8, scale) rows."""
        if self.share_quant and not isinstance(x, tuple):
            x = quantize_rows(x)
        if self.fuse:
            return self.w2(quant_fuse.silu_mul_quant(self.w1(x), self.w3(x)))
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class InternLM2DecoderLayer(nn.Module):
    """Pre-norm residual layer: (attention norm, attention, MLP norm, MLP),
    named by `NAMES`."""

    NAMES = ("attention_norm", "attention", "ffn_norm", "feed_forward")
    ATTENTION, MLP = InternLM2Attention, InternLM2MLP

    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        attn_norm, attn, mlp_norm, mlp = self.NAMES
        setattr(self, attn_norm, RMSNorm(config.hidden_size, config.rms_norm_eps))
        setattr(self, attn, self.ATTENTION(config, precision, lora))
        setattr(self, mlp_norm, RMSNorm(config.hidden_size, config.rms_norm_eps))
        setattr(self, mlp, self.MLP(config, precision, lora))
        self.fuse = getattr(self, mlp).fuse  # the norms' K5a feeds, off under adapters

    def _feed(self, norm: RMSNorm, x: torch.Tensor):
        """The norm's output; with fused W8A8 feeds its int8 rows and scales
        from the fused kernel (K5a)."""
        if self.fuse:
            return quant_fuse.rmsnorm_quant(x, norm.weight, norm.eps)
        return norm(x)

    def forward(self, x, cos, sin, position_ids, cache_k=None, cache_v=None,
                cache_index=None, cache_index_dev=None, kv_mask=None, capture_kv=False,
                block_causal=None, starts=None):
        """-> (x, the attention's new rows)."""
        attn_norm, attention, mlp_norm, mlp = (getattr(self, n) for n in self.NAMES)
        attn, new_rows = attention(
            self._feed(attn_norm, x), cos, sin, position_ids, cache_k, cache_v,
            cache_index, cache_index_dev, kv_mask, capture_kv, block_causal, starts)
        x = x + attn
        return x + mlp(self._feed(mlp_norm, x)), new_rows


class CausalDecoder(nn.Module):
    """What the decoders share: the layer loop over `self.layers` with the KV
    cache's writes, per-layer recompute in training and `capture_kv`, the
    final norm `self.norm`, the rope tables built once per (length, device),
    and each single-token step's `starts`. A subclass builds its modules and
    defines `embed(input_ids)`, `_build_rope(rope_len, device)` -> (cos,
    sin) and `logits(hidden)`."""

    def __init__(self, config, precision: Precision, grad_checkpoint: bool):
        super().__init__()
        self.config = config
        self.precision = precision
        self.grad_checkpoint = grad_checkpoint
        self._rope = {}  # (rope_len, device) -> (cos, sin)
        self.generator: Optional[torch.Generator] = None  # models/lora.set_generator

    @property
    def kv_heads(self) -> int:
        """The kv heads each layer holds: the config's, or this rank's share
        over `tensor`."""
        layer = self.layers[0]
        return getattr(layer, layer.NAMES[1]).hkv

    def _rope_tables(self, rope_len: int, device: torch.device):
        """The cos/sin tables of one length on one device, built once: a decode
        loop asks for the same table every step, and building it anew would
        copy it from the host each time."""
        key = (rope_len, device)
        if key not in self._rope:
            # ordinary tensors even when first asked for under inference_mode:
            # a later training forward may save them for its backward
            with torch.inference_mode(False):
                self._rope[key] = self._build_rope(rope_len, device)
        return self._rope[key]

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,  # [B, S]
        inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, C]
        position_ids: Optional[torch.Tensor] = None,  # [B, S]
        cache: Optional[KVCache] = None,
        kv_mask: Optional[torch.Tensor] = None,  # [B, max_len] bool, pad slots False
        rope_len: Optional[int] = None,
        with_logits: bool = True,
        capture_kv: bool = False,
        block_causal: Optional[int] = None,
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor, Optional[KVCache]]:
        """-> (logits [B, S, V] in `precision.logits_dtype` or None, final
        hidden state after the last norm [B, S, C], new cache or None).

        Positions default to `cache.index + arange(S)` (0 without a cache).
        The rope tables have `rope_len` rows: by default the cache's capacity
        with a cache, else S. With a cache its rows [index, index + S) are
        written in place and the returned cache has the index advanced.
        Without one, `capture_kv` returns the layers' roped k/v
        [L, B, S, Hkv, D] as a cache with index S."""
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        b, s, _ = inputs_embeds.shape
        device = inputs_embeds.device
        if position_ids is None:
            start = cache.index if cache is not None else 0
            position_ids = torch.arange(start, start + s, device=device).expand(b, s)
        if rope_len is None:
            rope_len = cache.max_len if cache is not None else s
        cos, sin = self._rope_tables(rope_len, device)

        x = inputs_embeds.to(self.norm.weight.dtype)
        remat = self.grad_checkpoint and torch.is_grad_enabled() and cache is None
        # a single-token step: each sample's first attended row, once for all layers
        starts = (window_starts(kv_mask, b, device)
                  if cache is not None and s == 1 and block_causal is None else None)
        captured = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x, (kn, vn) = layer(
                    x, cos, sin, position_ids, _layer_slot(cache.k, i), _layer_slot(cache.v, i),
                    cache.index, cache.index_dev, kv_mask, False, block_causal, starts)
                _write_rows(cache.k, kn, i, cache.index)
                _write_rows(cache.v, vn, i, cache.index)
            elif remat and not capture_kv:
                x = checkpoint_layer(lambda *a, layer=layer: layer(*a)[0], self.generator,
                                     x, cos, sin, position_ids)
            else:
                x, rows = layer(x, cos, sin, position_ids, capture_kv=capture_kv)
                captured.append(rows)
        hidden = self.norm(x)
        logits = self.logits(hidden) if with_logits else None

        new_cache = None
        if cache is not None:
            new_cache = KVCache(k=cache.k, v=cache.v, index=cache.index + s,
                                index_dev=cache.index_dev + s)
        elif capture_kv:
            new_cache = KVCache.from_prefix(torch.stack([kv[0] for kv in captured]),
                                            torch.stack([kv[1] for kv in captured]), 0)
        return logits, hidden, new_cache


class InternLM2ForCausalLM(CausalDecoder):
    def __init__(self, config: LLMConfig, precision: Precision = Precision(),
                 lora: Optional[LoRAConfig] = None, grad_checkpoint: bool = False):
        super().__init__(config, precision, grad_checkpoint)
        self.tok_embeddings = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            InternLM2DecoderLayer(config, precision, lora)
            for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        if config.tie_word_embeddings:
            self.output = None  # the logits read the embedding matrix
        elif precision.weight_only:
            self.output = weight_only_linear(precision)(
                config.hidden_size, config.vocab_size, bias=False,
                out_dtype=precision.compute_dtype)
        else:
            self.output = nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.tok_embeddings(input_ids)

    def _build_rope(self, rope_len: int, device: torch.device):
        cfg = self.config
        rs = cfg.rope_scaling
        return rope_cos_sin(
            rope_len,
            cfg.head_dim,
            base=cfg.rope_theta,
            scaling_type=rs.type if rs else None,
            scaling_factor=rs.factor if rs else 1.0,
            max_position_embeddings=cfg.max_position_embeddings,
            device=device,
        )

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[B, S, V] in `precision.logits_dtype`: the LM head, or with tied
        embeddings hidden @ embedding^T, both in the compute dtype."""
        if self.output is None:
            cd = self.precision.compute_dtype
            out = F.linear(hidden.to(cd), self.tok_embeddings.weight.to(cd))
        else:
            out = self.output(hidden)
        return out.to(self.precision.logits_dtype)


class InternLM2ForSequenceClassification(nn.Module):
    """The decoder (`model`) with a classification head
    (`aigv_assessor_tpu/models/internlm2.py:669-713`): the final hidden
    state of each sample's last non-padding token into a bias-free `score`
    Linear -> [B, num_labels] fp32."""

    def __init__(self, config: LLMConfig, num_labels: int = 2,
                 precision: Precision = Precision(), lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.precision = precision
        self.model = InternLM2ForCausalLM(config, precision, lora)
        self.score = nn.Linear(config.hidden_size, num_labels, bias=False)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,  # [B, S]
        inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, C]
        attention_mask: Optional[torch.Tensor] = None,  # [B, S], 1 = real
        position_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        # right padding needs no key mask (see the module docstring)
        _, hidden, _ = self.model(input_ids=input_ids, inputs_embeds=inputs_embeds,
                                  position_ids=position_ids, with_logits=False)
        b, s, _ = hidden.shape
        if attention_mask is not None:
            last = attention_mask.to(torch.int64).sum(dim=1) - 1
        else:
            last = torch.full((b,), s - 1, dtype=torch.int64, device=hidden.device)
        pooled = hidden[torch.arange(b, device=hidden.device), last]
        cd = self.precision.compute_dtype
        return F.linear(pooled.to(cd), self.score.weight.to(cd)).to(torch.float32)


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V], fp32
    labels: torch.Tensor,  # [B, S] int, ignore = ignore_index
    ignore_index: int = -100,
) -> torch.Tensor:
    """Shifted next-token cross-entropy, the mean over the non-ignored
    tokens (at least one counted), with an fp32 log-softmax
    (`aigv_assessor_tpu/models/internlm2.py:651-666`)."""
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum().clamp(min=1)
    return nll.sum() / count
