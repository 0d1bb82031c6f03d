"""The plain reference of AIGV-Assessor's stage-2 scoring forward, in fp32.

Plain PyTorch, written from the published descriptions (InternViT and
InternLM2 as in the InternVL2 model code, SlowFast-R50, AIGV-Assessor's
splice and score head): no kernel, cache or batching of the program, and no
import of it. The weights come group by group from `weights.SeededWeights`
(the benchmark's own draw, not the program's copy), so a model larger than
the card in fp32 (InternVL2-26B, ~102 GB) runs one layer at a time over
every sampled video. TF32 is switched off by the caller (`use_fp32`).

`Numerics(fp8=True)` is the control: every product (projections,
attention's two products, SlowFast's convolutions) takes its operands
rounded to fp8 e4m3 with a scale per row of the contraction, the step below
the bf16 the configurations are served in; norms, softmax and sums stay
fp32.

Departures from the published model, each shared with the program: the
ViT's MLP runs the tanh GELU where the config says `approximate_gelu`, and
the ViT's attention sees exactly its 1025 tokens (the program pads to 1032
and masks the pad keys).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def use_fp32() -> None:
    """Full fp32 products: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale per row of the last axis."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Numerics:
    """fp32 products, or (`fp8`) products of e4m3-rounded operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def mm_t(self, a, b):
        """a @ b^T, both contracted over their last axis."""
        return self.q(a) @ self.q(b).transpose(-1, -2)

    def conv(self, x, w, stride, padding, dims: int):
        """A convolution; under fp8 the input with one scale per sample,
        the weight with one per output channel."""
        if self.fp8:
            x = fp8_round(x.reshape(x.shape[0], -1)).view_as(x)
            w = fp8_round(w.flatten(1)).view_as(w)
        return (F.conv2d if dims == 2 else F.conv3d)(x, w, stride=stride, padding=padding)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _f32(group: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v.float() for k, v in group.items() if k.startswith(prefix)}


def attention(num: Numerics, q, k, v, causal: bool):
    """q [B, H, S, D], k / v [B, H, T, D] -> [B, H, S, D]."""
    s = num.mm_t(q, k) / math.sqrt(q.shape[-1])
    if causal:
        n_q, n_k = s.shape[-2:]
        s = s.masked_fill(torch.ones(n_q, n_k, dtype=torch.bool, device=s.device).triu(
            n_k - n_q + 1), float("-inf"))
    return num.mm_t(torch.softmax(s, dim=-1), v.transpose(-1, -2))


# ------------------------------------------------------------- InternViT --

def vit(cfg: dict, get: Callable, num: Numerics, pixels: torch.Tensor,
        frame_block: int = 8) -> torch.Tensor:
    """Normalized frames [F, H, W, 3] fp32 -> last layer's tokens [F, 1 + P, C]."""
    v = cfg["vision_config"]
    c, heads, eps = v["hidden_size"], v["num_attention_heads"], v["layer_norm_eps"]
    e = _f32(get("vision_model.embeddings"), "vision_model.embeddings.")
    x = num.conv(pixels.permute(0, 3, 1, 2), e["patch_embedding.weight"], v["patch_size"], 0, 2)
    x = x + e["patch_embedding.bias"].view(1, -1, 1, 1)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([e["class_embedding"].expand(x.shape[0], 1, c), x], dim=1)
    x = x + e["position_embedding"]
    n_layers = v["num_hidden_layers"]
    select = cfg.get("select_layer", -1)
    n_run = n_layers if select == -1 else select % (n_layers + 1)
    gelu = "tanh" if v.get("approximate_gelu") else "none"

    def norm(t, g, name):
        if v["norm_type"] == "rms_norm":
            return rms_norm(t, g[name + ".weight"], eps)
        return layer_norm(t, g[name + ".weight"], g[name + ".bias"], eps)

    d = c // heads
    for i in range(n_run):
        g = _f32(get(f"vision_model.layers.{i}"), f"vision_model.layers.{i}.")
        out = torch.empty_like(x)
        for s0 in range(0, x.shape[0], frame_block):
            h = norm(x[s0:s0 + frame_block], g, "norm1")
            qkv = num.linear(h, g["attn.qkv.weight"], g.get("attn.qkv.bias"))
            q, k, vv = qkv.split(c, dim=-1)
            if v.get("qk_normalization"):
                q = rms_norm(q, g["attn.q_norm.weight"], eps)
                k = rms_norm(k, g["attn.k_norm.weight"], eps)
            f, n, _ = q.shape
            q, k, vv = (t.reshape(f, n, heads, d).transpose(1, 2) for t in (q, k, vv))
            a = attention(num, q, k, vv, causal=False).transpose(1, 2).reshape(f, n, c)
            out[s0:s0 + frame_block] = num.linear(a, g["attn.proj.weight"], g["attn.proj.bias"])
        x = x + out * g["ls1"]
        for s0 in range(0, x.shape[0], frame_block):
            h = norm(x[s0:s0 + frame_block], g, "norm2")
            h = F.gelu(num.linear(h, g["mlp.fc1.weight"], g["mlp.fc1.bias"]), approximate=gelu)
            out[s0:s0 + frame_block] = num.linear(h, g["mlp.fc2.weight"], g["mlp.fc2.bias"])
        x = x + out * g["ls2"]
    return x


def pixel_shuffle(x: torch.Tensor, scale: float, version: str) -> torch.Tensor:
    """InternVL's pixel shuffle: [N, W, H, C] -> [N, H*s, W*s, C/s^2]."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale), int(c / scale)).permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale), int(w * scale), int(c / (scale * scale)))
    return x.permute(0, 2, 1, 3) if version != "v1" else x


def projector(num: Numerics, g: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (eps 1e-5) -> Linear -> erf GELU -> Linear."""
    x = layer_norm(x, g["ln.weight"], g["ln.bias"], 1e-5)
    x = F.gelu(num.linear(x, g["fc1.weight"], g["fc1.bias"]))
    return num.linear(x, g["fc2.weight"], g["fc2.bias"])


def frame_features(cfg: dict, get: Callable, num: Numerics, pixels: torch.Tensor) -> torch.Tensor:
    """[F, H, W, 3] -> mlp1's output [F, tokens, C_llm]."""
    x = vit(cfg, get, num, pixels)[:, 1:]
    n, l, c = x.shape
    side = int(l ** 0.5)
    x = pixel_shuffle(x.reshape(n, side, side, c), cfg["downsample_ratio"], cfg["ps_version"])
    return projector(num, _f32(get("mlp1"), "mlp1."), x.reshape(n, -1, x.shape[-1]))


# --------------------------------------------------------------- SlowFast --

def _conv_bn(num, g, name, x, stride=(1, 1, 1), relu=True):
    w = g[name + ".conv.weight"]
    x = num.conv(x, w, stride, tuple(k // 2 for k in w.shape[2:]), 3)
    inv = torch.rsqrt(g[name + ".bn.var"] + 1e-5) * g[name + ".bn.scale"]
    shift = g[name + ".bn.bias"] - g[name + ".bn.mean"] * inv
    x = x * inv.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1)
    return F.relu(x) if relu else x


def slowfast(cfg: dict, get: Callable, num: Numerics, frames: torch.Tensor) -> torch.Tensor:
    """Normalized frames [B, T, H, W, 3] -> SlowFast-R50's pooled features [B, 2304]."""
    m = cfg["motion_config"]
    g = _f32(get("slowfast_model"), "slowfast_model.")
    alpha = m["alpha"]
    t = frames.shape[1]
    idx = np.linspace(0, t - 1, max(1, t // alpha)).astype(np.int64)
    slow = frames[:, torch.from_numpy(idx).to(frames.device)].permute(0, 4, 1, 2, 3)
    fast = frames.permute(0, 4, 1, 2, 3)

    def stem(name, x):
        return F.max_pool3d(_conv_bn(num, g, name + ".conv", x, (1, 2, 2)), (1, 3, 3),
                            stride=(1, 2, 2), padding=(0, 1, 1))

    def fuse(name, slow, fast):
        return torch.cat([slow, _conv_bn(num, g, name + ".conv", fast, (alpha, 1, 1))], dim=1)

    slow, fast = stem("slow_stem", slow), stem("fast_stem", fast)
    slow = fuse("fuse_stem", slow, fast)
    for si, stride in enumerate((1, 2, 2, 2)):
        for path in ("slow", "fast"):
            x = slow if path == "slow" else fast
            for i in range(m["stage_depths"][si]):
                b = f"{path}_res{si + 2}.block_{i}."
                s = stride if i == 0 else 1
                branch = _conv_bn(num, g, b + "conv_a", x)
                branch = _conv_bn(num, g, b + "conv_b", branch, (1, s, s))
                branch = _conv_bn(num, g, b + "conv_c", branch, relu=False)
                if b + "shortcut.conv.weight" in g:
                    x = _conv_bn(num, g, b + "shortcut", x, (1, s, s), relu=False)
                x = F.relu(x + branch)
            if path == "slow":
                slow = x
            else:
                fast = x
        if si < 3:
            slow = fuse(f"fuse_res{si + 2}", slow, fast)
    feats = []
    for x, t_win in ((slow, 8), (fast, 32)):
        x = x.repeat_interleave(alpha, dim=2)
        win = (min(t_win, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        feats.append(F.avg_pool3d(x, win, stride=1).mean(dim=(2, 3, 4)))
    return torch.cat(feats, dim=-1)


# --------------------------------------------------------------- InternLM2 --

def rope_tables(l: dict, seq: int, device):
    """RoPE cos / sin [S, D] (rotate-half), with InternLM2's dynamic NTK
    base past max_position_embeddings."""
    d = l["hidden_size"] // l["num_attention_heads"]
    base = float(l["rope_theta"])
    rs = l.get("rope_scaling") or {}
    max_pos = l["max_position_embeddings"]
    if rs.get("type") == "dynamic" and seq > max_pos:
        factor = rs["factor"]
        base *= ((factor * seq / max_pos) - (factor - 1)) ** (d / (d - 2))
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    pos = torch.arange(seq, dtype=torch.float64)
    if rs.get("type") == "linear":
        pos = pos / rs["factor"]
    freqs = torch.outer(pos, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float().to(device), emb.sin().float().to(device)


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def decoder(cfg: dict, get: Callable, num: Numerics, x: torch.Tensor) -> torch.Tensor:
    """Prompt embeddings [B, S, C] -> hidden state after the final norm."""
    l = cfg["llm_config"]
    c, hq, hkv = l["hidden_size"], l["num_attention_heads"], l["num_key_value_heads"]
    d, eps = c // hq, l["rms_norm_eps"]
    b, s, _ = x.shape
    cos, sin = rope_tables(l, s, x.device)
    for i in range(l["num_hidden_layers"]):
        g = _f32(get(f"language_model.layers.{i}"), f"language_model.layers.{i}.")
        h = rms_norm(x, g["attention_norm.weight"], eps)
        qkv = num.linear(h, g["attention.wqkv.weight"], g.get("attention.wqkv.bias"))
        q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
        q = q.reshape(b, s, hq, d).transpose(1, 2)
        k = k.reshape(b, s, hkv, d).transpose(1, 2)
        v = v.reshape(b, s, hkv, d).transpose(1, 2)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        rep = hq // hkv
        out = torch.empty(b, hq, s, d, device=x.device)
        for j in range(b):
            out[j] = attention(num, q[j], k[j].repeat_interleave(rep, 0),
                               v[j].repeat_interleave(rep, 0), causal=True)
        x = x + num.linear(out.transpose(1, 2).reshape(b, s, c), g["attention.wo.weight"],
                           g.get("attention.wo.bias"))
        h = rms_norm(x, g["ffn_norm.weight"], eps)
        gate = F.silu(num.linear(h, g["feed_forward.w1.weight"]))
        h = gate * num.linear(h, g["feed_forward.w3.weight"])
        x = x + num.linear(h, g["feed_forward.w2.weight"])
    head = _f32(get("language_model.head"), "language_model.")
    return rms_norm(x, head["norm.weight"], eps)


# ---------------------------------------------------------------- scoring --

def normalize(pixels_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=pixels_u8.device)
    std = torch.tensor(IMAGENET_STD, device=pixels_u8.device)
    return (pixels_u8.float() / 255.0 - mean) / std


def score_videos(cfg: dict, get: Callable, num: Numerics, ids: torch.Tensor,
                 pixels_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Stage-2 scores of B videos under one prompt, and what they pass through.

    ids [S] int64 (every position real), pixels_u8 [B, T, H, W, 3] ->
    {'features' [B, T * tokens, C] (mlp1's output), 'motion' [B, C]
    (motion_mlp's), 'readout' [B, C] (the final hidden state at
    S + score_readout_pos), 'score' [B]}, all fp32."""
    b, t = pixels_u8.shape[:2]
    frames = normalize(pixels_u8)
    feats = frame_features(cfg, get, num, frames.reshape((b * t,) + frames.shape[2:]))
    feats = feats.reshape(b, -1, feats.shape[-1])
    motion = projector(num, _f32(get("motion_mlp"), "motion_mlp."),
                       slowfast(cfg, get, num, frames))
    emb = get("language_model.tok_embeddings")["language_model.tok_embeddings.weight"]
    x = emb[ids].float().expand(b, -1, -1).clone()
    slots = torch.nonzero(ids == cfg["img_context_token_id"]).flatten()
    if slots.numel() != feats.shape[1] + 1:
        raise ValueError(f"{slots.numel()} <IMG_CONTEXT> slots for {feats.shape[1]} "
                         "frame tokens and one motion token")
    x[:, slots[:-1]] = feats
    x[:, slots[-1]] = motion
    del emb
    hidden = decoder(cfg, get, num, x)
    readout = torch.nan_to_num(hidden[:, ids.shape[0] + cfg["score_readout_pos"]],
                               nan=0.0, posinf=1e9, neginf=-1e9)
    return {"features": feats, "motion": motion, "readout": readout,
            "score": score_head(cfg, get, num, readout)}


def score_head(cfg: dict, get: Callable, num: Numerics, readout: torch.Tensor) -> torch.Tensor:
    """The stage-2 score head: readout [B, C] -> scores [B], ReLU after every layer."""
    g = _f32(get("mlpscore"), "mlpscore.")
    y = readout
    for i in range(len(cfg["score_head_dims"])):
        y = F.relu(num.linear(y, g[f"fc{i + 1}.weight"], g[f"fc{i + 1}.bias"]))
    return y[:, 0]
