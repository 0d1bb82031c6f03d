"""A synthetic reference-format checkpoint, without JAX
(`aigv_assessor_tpu/tools/make_synthetic_ckpt.py`).

Real InternVL2 / AIGV-Assessor checkpoints ship as sharded safetensors
(`model-0000x-of-0000y.safetensors` + `model.safetensors.index.json`) under
the torch module names of the composite model, with `config.json` and a
tokenizer. This tool writes the same names, orientations and files with
random values from a seed: at the tiny scale by default
(`make_synthetic_checkpoint`, JAX's files for the same seed, byte for byte),
or at any config through `reference_state_dict` + `slowfast_state_dict` +
`write_sharded_safetensors`, which `chip_smoke.py` uses at InternVL2-2B's
full size.

The values are drawn from one numpy generator in JAX's order: the ViT, the
decoder (its wqkv in the reference's interleaved layout), the projectors
and the score head, then every SlowFast leaf in the order of flax's
`flatten_dict` over `SlowFastR50.init`, which sorts each level's names
(`slowfast_paths`, built from the port's SlowFast module).

Usage:
  python -m aigv_assessor_torch.tools.make_synthetic_ckpt --out ckpt_dir \\
      [--shards 2] [--seed 0] [--no-slowfast]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from aigv_assessor_torch.core.config import AssessorConfig


def reference_state_dict(cfg: AssessorConfig, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Reference-named torch-orientation tensors for `cfg`, all but the
    SlowFast branch (`slowfast_state_dict`): the ViT encoder, the InternLM2
    decoder with the interleaved fused wqkv (`modeling_internlm2.py:375-385`),
    the mlp1 / motion_mlp projectors (torch Sequential indices 0/1/3) and the
    score head."""
    v, l = cfg.vision, cfg.llm
    sd: Dict[str, np.ndarray] = {}

    def r(*shape):
        return rng.normal(scale=0.02, size=shape).astype(np.float32)

    sd["vision_model.embeddings.class_embedding"] = r(1, 1, v.hidden_size)
    sd["vision_model.embeddings.position_embedding"] = r(1, v.num_patches + 1, v.hidden_size)
    sd["vision_model.embeddings.patch_embedding.weight"] = r(
        v.hidden_size, 3, v.patch_size, v.patch_size)
    sd["vision_model.embeddings.patch_embedding.bias"] = r(v.hidden_size)
    for i in range(v.num_hidden_layers):
        p = f"vision_model.encoder.layers.{i}."
        sd[p + "attn.qkv.weight"] = r(3 * v.hidden_size, v.hidden_size)
        sd[p + "attn.qkv.bias"] = r(3 * v.hidden_size)
        sd[p + "attn.proj.weight"] = r(v.hidden_size, v.hidden_size)
        sd[p + "attn.proj.bias"] = r(v.hidden_size)
        sd[p + "mlp.fc1.weight"] = r(v.intermediate_size, v.hidden_size)
        sd[p + "mlp.fc1.bias"] = r(v.intermediate_size)
        sd[p + "mlp.fc2.weight"] = r(v.hidden_size, v.intermediate_size)
        sd[p + "mlp.fc2.bias"] = r(v.hidden_size)
        sd[p + "norm1.weight"] = r(v.hidden_size)
        sd[p + "norm1.bias"] = r(v.hidden_size)
        sd[p + "norm2.weight"] = r(v.hidden_size)
        sd[p + "norm2.bias"] = r(v.hidden_size)
        sd[p + "ls1"] = r(v.hidden_size)
        sd[p + "ls2"] = r(v.hidden_size)
    sd["language_model.model.tok_embeddings.weight"] = r(l.vocab_size, l.hidden_size)
    sd["language_model.model.norm.weight"] = r(l.hidden_size)
    sd["language_model.output.weight"] = r(l.vocab_size, l.hidden_size)
    for i in range(l.num_hidden_layers):
        p = f"language_model.model.layers.{i}."
        g = l.num_key_value_groups
        sd[p + "attention.wqkv.weight"] = r(l.num_key_value_heads * (g + 2) * l.head_dim,
                                            l.hidden_size)
        sd[p + "attention.wo.weight"] = r(l.hidden_size, l.hidden_size)
        sd[p + "feed_forward.w1.weight"] = r(l.intermediate_size, l.hidden_size)
        sd[p + "feed_forward.w3.weight"] = r(l.intermediate_size, l.hidden_size)
        sd[p + "feed_forward.w2.weight"] = r(l.hidden_size, l.intermediate_size)
        sd[p + "attention_norm.weight"] = r(l.hidden_size)
        sd[p + "ffn_norm.weight"] = r(l.hidden_size)
    vit4 = v.hidden_size * 4
    sd["mlp1.0.weight"] = r(vit4)
    sd["mlp1.0.bias"] = r(vit4)
    sd["mlp1.1.weight"] = r(l.hidden_size, vit4)
    sd["mlp1.1.bias"] = r(l.hidden_size)
    sd["mlp1.3.weight"] = r(l.hidden_size, l.hidden_size)
    sd["mlp1.3.bias"] = r(l.hidden_size)
    sd["motion_mlp.0.weight"] = r(cfg.motion.feature_dim)
    sd["motion_mlp.0.bias"] = r(cfg.motion.feature_dim)
    sd["motion_mlp.1.weight"] = r(l.hidden_size, cfg.motion.feature_dim)
    sd["motion_mlp.1.bias"] = r(l.hidden_size)
    sd["motion_mlp.3.weight"] = r(l.hidden_size, l.hidden_size)
    sd["motion_mlp.3.bias"] = r(l.hidden_size)
    if cfg.stage >= 2:
        dims = (cfg.llm.hidden_size,) + cfg.score_head_dims
        for i in range(len(cfg.score_head_dims)):
            sd[f"mlpscore.fc{i + 1}.weight"] = r(dims[i + 1], dims[i])
            sd[f"mlpscore.fc{i + 1}.bias"] = r(dims[i + 1])
    return sd


_BN_LEAF_INV = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def flax_slowfast_path_to_torch(path: Tuple[str, ...]) -> str:
    """A flax path of the SlowFastR50 tree -> the pytorchvideo name the
    reference's wrapper exposes (`slowfast_model.feature_extraction.{block}...`):
    the inverse of `convert_weights.map_slowfast_key`."""
    top = path[0]

    def bn_or_conv(rest: Tuple[str, ...], conv_name: str, norm_name: str) -> str:
        if rest[0] == "conv":
            return f"{conv_name}.weight"
        return f"{norm_name}.{_BN_LEAF_INV[rest[1]]}"

    m = re.match(r"(slow|fast)_stem$", top)
    if m:
        pw = 0 if m.group(1) == "slow" else 1
        tail = bn_or_conv(path[2:], "conv", "norm")
        return f"slowfast_model.feature_extraction.0.multipathway_blocks.{pw}.{tail}"
    m = re.match(r"fuse_(stem|res(\d))$", top)
    if m:
        block = 0 if m.group(1) == "stem" else int(m.group(2)) - 1
        tail = bn_or_conv(path[2:], "conv_fast_to_slow", "norm")
        return f"slowfast_model.feature_extraction.{block}.multipathway_fusion.{tail}"
    m = re.match(r"(slow|fast)_res(\d)$", top)
    if m:
        pw = 0 if m.group(1) == "slow" else 1
        block = int(m.group(2)) - 1
        j = path[1].split("_")[1]  # block_{j}
        sub = path[2]  # conv_a | conv_b | conv_c | shortcut
        if sub == "shortcut":
            tail = bn_or_conv(path[3:], "branch1_conv", "branch1_norm")
        else:
            tail = bn_or_conv(path[3:], f"branch2.{sub}", f"branch2.norm_{sub[-1]}")
        return (f"slowfast_model.feature_extraction.{block}.multipathway_blocks.{pw}"
                f".res_blocks.{j}.{tail}")
    raise KeyError(f"unmapped slowfast flax path: {path}")


def slowfast_paths(cfg: AssessorConfig) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(flax path, flax shape) of every leaf of the SlowFastR50 tree at
    `cfg.motion` scale, in the order of flax's `flatten_dict` over its init
    (each level's names sorted): the port's SlowFast module's leaves under
    their JAX names, conv kernels in DHWIO."""
    from aigv_assessor_torch.models.loading import jax_paths
    from aigv_assessor_torch.models.motion import SlowFastR50

    with torch.device("meta"):
        model = SlowFastR50(cfg.motion)
    state = model.state_dict()
    out = []
    for name, (path, _) in jax_paths(model).items():
        shape = tuple(state[name].shape)
        if len(shape) == 5:  # OIDHW -> DHWIO
            shape = shape[2:] + (shape[1], shape[0])
        out.append((tuple(path.split("/")), shape))
    return sorted(out)


def slowfast_state_dict(cfg: AssessorConfig, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """pytorchvideo-named tensors for every leaf of the SlowFastR50 at
    `cfg.motion` scale, torch NCDHW, plus the `num_batches_tracked`
    counters real checkpoints carry (the converter skips them)."""
    sd: Dict[str, np.ndarray] = {}
    for path, shape in slowfast_paths(cfg):
        torch_key = flax_slowfast_path_to_torch(path)
        leaf = path[-1]
        if leaf == "var":  # BN running_var must be positive (rsqrt)
            val = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        elif leaf == "scale":  # BN weight near 1, as in trained nets
            val = rng.uniform(0.8, 1.2, size=shape).astype(np.float32)
        else:
            val = rng.normal(scale=0.02, size=shape).astype(np.float32)
        if leaf == "kernel":  # flax DHWIO -> torch [O, I, D, H, W]
            val = val.transpose(4, 3, 0, 1, 2)
        sd[torch_key] = np.ascontiguousarray(val)
        if torch_key.endswith("running_var"):
            sd[torch_key.replace("running_var", "num_batches_tracked")] = np.zeros((), np.int64)
    return sd


def reference_config_dict(cfg: AssessorConfig) -> dict:
    """config.json in the reference's composite format
    (`configuration_internvl_chat.py:20-108`: vision_config / llm_config
    sub-dicts and the pipeline fields)."""
    llm_d = dataclasses.asdict(cfg.llm)
    llm_d["architectures"] = [llm_d.pop("architecture")]
    rs = llm_d.get("rope_scaling")
    if rs is not None:
        llm_d["rope_scaling"] = {"type": rs["type"], "factor": rs["factor"]}
    return {
        "model_type": "internvl_chat",
        "vision_config": dataclasses.asdict(cfg.vision),
        "llm_config": llm_d,
        "motion_config": dataclasses.asdict(cfg.motion),
        "score_head_dims": list(cfg.score_head_dims),
        "downsample_ratio": cfg.downsample_ratio,
        "ps_version": cfg.ps_version,
        "select_layer": cfg.select_layer,
        "template": cfg.template,
        "force_image_size": cfg.force_image_size,
        "max_dynamic_patch": cfg.max_dynamic_patch,
        "min_dynamic_patch": cfg.min_dynamic_patch,
        "dynamic_image_size": cfg.dynamic_image_size,
        "use_thumbnail": cfg.use_thumbnail,
        "pad2square": cfg.pad2square,
    }


def write_sharded_safetensors(sd: Dict[str, np.ndarray], out_dir: str,
                              n_shards: int = 2) -> List[str]:
    """Write `sd` as HF-style sharded safetensors, floats in bf16 as real
    checkpoints are, with `model.safetensors.index.json`."""
    from safetensors.torch import save_file

    keys = sorted(sd.keys())
    shards: List[List[str]] = [[] for _ in range(n_shards)]
    sizes = [0] * n_shards
    for k in keys:  # greedy size-balanced sharding
        i = sizes.index(min(sizes))
        shards[i].append(k)
        sizes[i] += sd[k].nbytes
    names = [f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors" for i in range(n_shards)]
    weight_map = {}
    for name, shard_keys in zip(names, shards):
        tensors = {k: (torch.from_numpy(sd[k]).to(torch.bfloat16)
                       if np.issubdtype(sd[k].dtype, np.floating) else torch.from_numpy(sd[k]))
                   for k in shard_keys}
        save_file(tensors, os.path.join(out_dir, name))
        for k in shard_keys:
            weight_map[k] = name
    index = {"metadata": {"total_size": int(sum(v.nbytes for v in sd.values()))},
             "weight_map": weight_map}
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)
    return names


def write_config_and_tokenizer(cfg: AssessorConfig, tokenizer, out_dir: str) -> None:
    """`config.json` (`reference_config_dict`) and `tokenizer.json`."""
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(reference_config_dict(cfg), f, indent=2, sort_keys=True)
    tokenizer._tk.save(os.path.join(out_dir, "tokenizer.json"))


def make_synthetic_checkpoint(out_dir: str, stage: int = 2, n_shards: int = 2, seed: int = 0,
                              with_slowfast: bool = True) -> AssessorConfig:
    from aigv_assessor_torch.data.tokenizer import build_test_tokenizer

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    tokenizer = build_test_tokenizer()
    cfg = AssessorConfig.tiny(stage=stage).replace(
        img_context_token_id=int(tokenizer.img_context_token_id))
    sd = reference_state_dict(cfg, rng)
    if with_slowfast:
        sd.update(slowfast_state_dict(cfg, rng))
    write_sharded_safetensors(sd, out_dir, n_shards)
    write_config_and_tokenizer(cfg, tokenizer, out_dir)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--stage", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-slowfast", action="store_true")
    args = ap.parse_args(argv)
    make_synthetic_checkpoint(args.out, args.stage, args.shards, args.seed, not args.no_slowfast)
    print(f"wrote synthetic reference-format checkpoint to {args.out}")


if __name__ == "__main__":
    main()
