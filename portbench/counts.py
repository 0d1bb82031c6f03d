"""The yardstick's arithmetic: model FLOPs, attention work and the H100's
published peaks, from a configuration file and the traffic's shapes alone.

Frozen here so that no change to the program moves it. The bound arithmetic
is `chip_smoke.py`'s (max of FLOPs over the bf16 peak and bytes over the
HBM peak), with the shapes taken from the configuration.

Model FLOPs of one video (`video_flops`): every projection of both towers
as 2 * M * K * N (the ViT's patch embedding included), `mlp1`,
`motion_mlp` and the score head, and attention at the pairs it needs: the
ViT's 1025 real tokens (not the program's pad to 1032), the decoder's
causal S (S + 1) / 2 pairs per head. SlowFast's convolutions are left out
(under 1% of a video's FLOPs at 448 px).
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal attention over s positions computes."""
    return s * (s + 1) // 2


def full_pairs(n_q: int, kv_valid: int) -> int:
    """Pairs of a non-causal attention of n_q queries over kv_valid keys."""
    return n_q * kv_valid


def vit_tokens(cfg: dict) -> int:
    v = cfg["vision_config"]
    size = cfg.get("force_image_size") or v["image_size"]
    return (size // v["patch_size"]) ** 2 + 1


def image_tokens(cfg: dict) -> int:
    """Decoder tokens per frame after the pixel shuffle."""
    v = cfg["vision_config"]
    size = cfg.get("force_image_size") or v["image_size"]
    return int((size // v["patch_size"]) ** 2 * cfg["downsample_ratio"] ** 2)


def prompt_len(cfg: dict, frames: int, text_tokens: int) -> int:
    """The scoring prompt: every frame's tokens, the motion slot and the text."""
    return frames * image_tokens(cfg) + 1 + text_tokens


def attention_work(cfg: dict, frames: int, text_tokens: int) -> Dict[str, Dict[str, float]]:
    """Per video: each tower's attention forward as FLOPs (two products of
    2 * pairs * D) and bytes (q, k, v and out in bf16 moved once, lse in
    fp32), and the backward's FLOPs (five products)."""
    v, l = cfg["vision_config"], cfg["llm_config"]
    n = vit_tokens(cfg)
    dv = v["hidden_size"] // v["num_attention_heads"]
    vit_pairs = full_pairs(n, n) * v["num_attention_heads"] * v["num_hidden_layers"] * frames
    vit_bytes = (4 * n * v["hidden_size"] * 2 + n * v["num_attention_heads"] * 4) * (
        v["num_hidden_layers"] * frames)
    s = prompt_len(cfg, frames, text_tokens)
    hq, hkv = l["num_attention_heads"], l["num_key_value_heads"]
    dl = l["hidden_size"] // hq
    llm_pairs = causal_pairs(s) * hq * l["num_hidden_layers"]
    llm_bytes = (s * (2 * hq + 2 * hkv) * dl * 2 + s * hq * 4) * l["num_hidden_layers"]
    return {
        "vit": {"flops": 4.0 * vit_pairs * dv, "bytes": float(vit_bytes),
                "bwd_flops": 10.0 * vit_pairs * dv},
        "llm": {"flops": 4.0 * llm_pairs * dl, "bytes": float(llm_bytes),
                "bwd_flops": 10.0 * llm_pairs * dl},
    }


def video_flops(cfg: dict, frames: int, text_tokens: int) -> Dict[str, float]:
    """Model FLOPs of scoring one video, by part; 'total' sums them."""
    v, l, m = cfg["vision_config"], cfg["llm_config"], cfg["motion_config"]
    c, f = v["hidden_size"], v["intermediate_size"]
    n = vit_tokens(cfg)
    patch = 2.0 * (n - 1) * v["num_channels"] * v["patch_size"] ** 2 * c
    vit = frames * (patch + 2.0 * n * (4 * c * c + 2 * c * f) * v["num_hidden_layers"])
    h = l["hidden_size"]
    d = h // l["num_attention_heads"]
    qkv_out = (l["num_attention_heads"] + 2 * l["num_key_value_heads"]) * d
    per_layer = h * qkv_out + h * h + 3 * h * l["intermediate_size"]
    s = prompt_len(cfg, frames, text_tokens)
    decoder = 2.0 * s * per_layer * l["num_hidden_layers"]
    shuffle = int(round(1 / cfg["downsample_ratio"])) ** 2
    mlp1 = 2.0 * frames * image_tokens(cfg) * (c * shuffle * h + h * h)
    motion_mlp = 2.0 * (m["feature_dim"] * h + h * h)
    dims = [h] + list(cfg["score_head_dims"])
    head = 2.0 * sum(a * b for a, b in zip(dims, dims[1:]))
    attn = attention_work(cfg, frames, text_tokens)
    parts = {"vit": vit, "vit_attention": attn["vit"]["flops"], "decoder": decoder,
             "decoder_attention": attn["llm"]["flops"], "mlp1": mlp1,
             "motion_mlp": motion_mlp, "score_head": head}
    parts["total"] = sum(parts.values())
    return parts


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
