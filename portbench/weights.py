"""Seeded weights of an AIGV-Assessor configuration, drawn on the device.

The benchmark makes the weights, hands them to the program as a state_dict
(`SeededWeights`, a lazy `Mapping`) and draws them again for the plain
reference, which reads them group by group (`SeededWeights.group`). A group
is one layer, or one embedding, projector or head: its leaves come from a
single `torch.randn` call, from a generator seeded by (seed, group name), in
the dtype the model is served in, then scaled leaf by leaf. So any group can
be drawn again alone, bit for bit, and no more than one group is held at a
time: InternVL2-26B's 25.5 G values never exist twice.

The names and shapes are the port's `state_dict` names (HF / JAX naming);
`param_spec` derives them from the configuration file alone. Scales:
projections and embeddings N(0, initializer_range); norm weights and
LayerScale around their initial value; SlowFast's convolutions He-scaled
with batch norm near the identity; the score head fan-in scaled, its last
layer's weights non-negative.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import torch

# (name, shape, mean, std): the leaf is mean + std * N(0, 1); a negative std
# draws mean + |std * N(0, 1)|
Leaf = Tuple[str, Tuple[int, ...], float, float]


def _linear(name: str, out_f: int, in_f: int, std: float, bias: bool = True) -> List[Leaf]:
    leaves = [(f"{name}.weight", (out_f, in_f), 0.0, std)]
    if bias:
        leaves.append((f"{name}.bias", (out_f,), 0.0, 0.02))
    return leaves


def _norm(name: str, dim: int, with_bias: bool) -> List[Leaf]:
    leaves = [(f"{name}.weight", (dim,), 1.0, 0.02)]
    if with_bias:
        leaves.append((f"{name}.bias", (dim,), 0.0, 0.02))
    return leaves


def _conv_bn(name: str, c_in: int, c_out: int, kernel: Tuple[int, int, int]) -> List[Leaf]:
    fan_in = c_in * kernel[0] * kernel[1] * kernel[2]
    return [
        (f"{name}.conv.weight", (c_out, c_in) + tuple(kernel), 0.0, (2.0 / fan_in) ** 0.5),
        (f"{name}.bn.scale", (c_out,), 1.0, 0.02),
        (f"{name}.bn.bias", (c_out,), 0.0, 0.02),
        (f"{name}.bn.mean", (c_out,), 0.0, 0.02),
        (f"{name}.bn.var", (c_out,), 1.0, 0.02),
    ]


def slowfast_stages(m: dict):
    """SlowFast-R50's stages as (slow_inner, slow_out, fast_inner, fast_out,
    slow temporal kernel, spatial stride), and the stems' and fusions'
    widths, from the motion config."""
    sw, fw = m["slow_width"], m["fast_width"]
    return [
        (sw, sw * 4, fw, fw * 4, 1, 1),
        (sw * 2, sw * 8, fw * 2, fw * 8, 1, 2),
        (sw * 4, sw * 16, fw * 4, fw * 16, 3, 2),
        (sw * 8, sw * 32, fw * 8, fw * 32, 3, 2),
    ]


def _slowfast(m: dict) -> List[Leaf]:
    p = "slowfast_model."
    sw, fw, r, fk = m["slow_width"], m["fast_width"], m["fusion_conv_ratio"], m["fusion_kernel"]
    leaves = _conv_bn(p + "slow_stem.conv", 3, sw, (1, 7, 7))
    leaves += _conv_bn(p + "fast_stem.conv", 3, fw, (5, 7, 7))
    leaves += _conv_bn(p + "fuse_stem.conv", fw, fw * r, (fk, 1, 1))
    slow_in, fast_in = sw + fw * r, fw
    for si, (s_inner, s_out, f_inner, f_out, s_tk, stride) in enumerate(slowfast_stages(m)):
        for path, d_in, inner, out, tk in (("slow", slow_in, s_inner, s_out, s_tk),
                                            ("fast", fast_in, f_inner, f_out, 3)):
            for i in range(m["stage_depths"][si]):
                b = f"{p}{path}_res{si + 2}.block_{i}."
                c_in = d_in if i == 0 else out
                leaves += _conv_bn(b + "conv_a", c_in, inner, (tk, 1, 1))
                leaves += _conv_bn(b + "conv_b", inner, inner, (1, 3, 3))
                leaves += _conv_bn(b + "conv_c", inner, out, (1, 1, 1))
                if i == 0 and (c_in != out or stride != 1):
                    leaves += _conv_bn(b + "shortcut", c_in, out, (1, 1, 1))
        slow_in, fast_in = s_out, f_out
        if si < 3:
            leaves += _conv_bn(f"{p}fuse_res{si + 2}.conv", f_out, f_out * r, (fk, 1, 1))
            slow_in += f_out * r
    return leaves


def param_spec(cfg: dict) -> List[Tuple[str, List[Leaf]]]:
    """[(group, leaves)] of the stage-2 model of a configuration file's
    `config`, in the order the program's modules hold them."""
    v, l, m = cfg["vision_config"], cfg["llm_config"], cfg["motion_config"]
    groups: List[Tuple[str, List[Leaf]]] = []
    c, f, std = v["hidden_size"], v["intermediate_size"], v.get("initializer_range", 0.02)
    side = v["image_size"] // v["patch_size"]
    pe = "vision_model.embeddings."
    groups.append(("vision_model.embeddings", [
        (pe + "class_embedding", (1, 1, c), 0.0, std),
        (pe + "position_embedding", (1, side * side + 1, c), 0.0, std),
        (pe + "patch_embedding.weight", (c, v["num_channels"], v["patch_size"], v["patch_size"]),
         0.0, std),
        (pe + "patch_embedding.bias", (c,), 0.0, std),
    ]))
    ln = v["norm_type"] != "rms_norm"
    factor = v.get("initializer_factor", 1.0)
    for i in range(v["num_hidden_layers"]):
        p = f"vision_model.layers.{i}."
        leaves = [(p + "ls1", (c,), factor, 0.02 * factor), (p + "ls2", (c,), factor, 0.02 * factor)]
        leaves += _norm(p + "norm1", c, ln)
        leaves += _linear(p + "attn.qkv", 3 * c, c, std, v["qkv_bias"])
        if v.get("qk_normalization"):
            leaves += _norm(p + "attn.q_norm", c, False) + _norm(p + "attn.k_norm", c, False)
        leaves += _linear(p + "attn.proj", c, c, std)
        leaves += _norm(p + "norm2", c, ln)
        leaves += _linear(p + "mlp.fc1", f, c, std) + _linear(p + "mlp.fc2", c, f, std)
        groups.append((f"vision_model.layers.{i}", leaves))

    h, std_l = l["hidden_size"], l.get("initializer_range", 0.02)
    d = h // l["num_attention_heads"]
    qkv_out = (l["num_attention_heads"] + 2 * l["num_key_value_heads"]) * d
    bias = bool(l.get("bias", False))
    groups.append(("language_model.tok_embeddings",
                   [("language_model.tok_embeddings.weight", (l["vocab_size"], h), 0.0, std_l)]))
    for i in range(l["num_hidden_layers"]):
        p = f"language_model.layers.{i}."
        groups.append((f"language_model.layers.{i}", (
            _norm(p + "attention_norm", h, False)
            + _linear(p + "attention.wqkv", qkv_out, h, std_l, bias)
            + _linear(p + "attention.wo", h, h, std_l, bias)
            + _norm(p + "ffn_norm", h, False)
            + _linear(p + "feed_forward.w1", l["intermediate_size"], h, std_l, False)
            + _linear(p + "feed_forward.w3", l["intermediate_size"], h, std_l, False)
            + _linear(p + "feed_forward.w2", h, l["intermediate_size"], std_l, False))))
    head = _norm("language_model.norm", h, False)
    if not l.get("tie_word_embeddings", False):
        head += _linear("language_model.output", l["vocab_size"], h, std_l, False)
    groups.append(("language_model.head", head))

    shuffle = int(round(1 / cfg["downsample_ratio"])) ** 2
    for name, d_in in (("mlp1", c * shuffle), ("motion_mlp", m["feature_dim"])):
        groups.append((name, _norm(name + ".ln", d_in, True)
                       + _linear(name + ".fc1", h, d_in, std)
                       + _linear(name + ".fc2", h, h, std)))
    groups.append(("slowfast_model", _slowfast(m)))
    score: List[Leaf] = []
    dims = cfg["score_head_dims"]
    d_in = h
    for i, d_out in enumerate(dims):
        # the last layer's weights non-negative: its inputs are ReLU outputs,
        # so the final ReLU rarely clips a score to 0, and the score carries
        # no constant that would hide its error under bf16's rounding
        last = i == len(dims) - 1
        score += _linear(f"mlpscore.fc{i + 1}", d_out, d_in, -d_in ** -0.5 if last else d_in ** -0.5)
        d_in = d_out
    groups.append(("mlpscore", score))
    return groups


def group_seed(seed: int, group: str) -> int:
    """The generator seed of one group: 63 bits of sha256(seed, name)."""
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def draw_group(leaves: List[Leaf], seed: int, group: str, device, dtype) -> Dict[str, torch.Tensor]:
    """One group's leaves from one `randn` call in `dtype` on `device`."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out = {}
    for (name, shape, mean, std), part in zip(leaves, flat.split(sizes)):
        t = part.view(shape).mul_(std)
        if std < 0:
            t.abs_()
        if mean:
            t.add_(mean)
        out[name] = t
    return out


class SeededWeights(Mapping):
    """The state_dict of a configuration's model, drawn group by group on
    demand: a lookup draws the name's group unless it is the last one drawn."""

    def __init__(self, cfg: dict, seed: int, device, dtype: torch.dtype):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.spec = dict(param_spec(cfg))
        self._group_of = {leaf[0]: g for g, leaves in self.spec.items() for leaf in leaves}
        self._held: Tuple[str, Dict[str, torch.Tensor]] = ("", {})

    def group(self, name: str) -> Dict[str, torch.Tensor]:
        if self._held[0] != name:
            self._held = ("", {})  # let the previous group go before drawing
            self._held = (name, draw_group(self.spec[name], self.seed, name,
                                           self.device, self.dtype))
        return self._held[1]

    def release(self) -> None:
        self._held = ("", {})

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.group(self._group_of[name])[name]

    def __contains__(self, name) -> bool:
        return name in self._group_of

    def __iter__(self) -> Iterator[str]:
        return iter(self._group_of)

    def __len__(self) -> int:
        return len(self._group_of)
