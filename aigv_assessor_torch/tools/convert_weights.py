"""Reference checkpoint -> the JAX package's parameter tree, with numpy
leaves: a jax-free copy of the name map in
`aigv_assessor_tpu/tools/convert_weights.py`, which the port cannot import.
`models/loading.load_reference_checkpoint` maps the tree onto the port's
`state_dict` (`state_dict_from_jax`); `tests/test_torch_cli.py` holds the
two steps bit for bit against the JAX converter.

Reads a torch `state_dict` (pytorch_model*.bin / .pth, or sharded
safetensors with their index, as real InternVL2 checkpoints ship).

Key transforms:
- GQA fused wqkv de-interleave: the reference keeps an interleaved
  `(h, gs, d)` row layout (`modeling_internlm2.py:375-385`, gs = 2 +
  n_groups with q-groups first, then k, then v per kv head). It is converted
  once to the [q | k | v] row order both packages use.
- conv kernels NCHW->HWIO (ViT patch embed) and NCDHW->DHWIO (SlowFast 3D).
- torch Linear [out, in] -> flax kernel [in, out].
- LoRA-wrapped checkpoints (peft names `base_model.model.` /
  `base_layer.` / `lora_A.default.weight`) are normalized first.
- the per-layer subtrees `layers_{i}` of each tower are stacked into one
  `layers` subtree with a leading [L] axis, the scan-over-layers form that
  `state_dict_from_jax` reads.

Usage (the JAX tool's flags; the same `params.msgpack`, byte for byte,
written by `utils/flax_msgpack` without flax; a tower whose config has
`scan_layers` false is written unrolled, as the JAX tool writes it):
  python -m aigv_assessor_torch.tools.convert_weights \
      --torch_ckpt /path/to/checkpoint_dir_or_files [...more shards] \
      --config /path/to/config.json --out params.msgpack [--strict]
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from aigv_assessor_torch.core.config import AssessorConfig

logger = logging.getLogger(__name__)
_LAYER_RE = re.compile(r"^layers_(\d+)$")


def resolve_checkpoint_files(path: str) -> List[str]:
    """Resolve a checkpoint directory (or single file) to the weight files.

    Real InternVL2 checkpoints ship as sharded safetensors with an index —
    `model-0000x-of-0000y.safetensors` + `model.safetensors.index.json`
    (loaded by the reference via HF `from_pretrained`,
    `internvl/train/stage1_train.py:819-820` of the reference).
    Resolution order matches HF: safetensors index, bin index, single
    `model.safetensors` / `pytorch_model.bin`, then globbed shards.
    """
    if not os.path.isdir(path):
        return [path]
    for idx_name in (
        "model.safetensors.index.json",
        "pytorch_model.bin.index.json",
    ):
        idx = os.path.join(path, idx_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            return [os.path.join(path, s) for s in sorted(set(weight_map.values()))]
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return [p]
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if shards:
        return shards
    shards = sorted(
        glob.glob(os.path.join(path, "pytorch_model*.bin"))
        + glob.glob(os.path.join(path, "*.pth"))
    )
    if shards:
        return shards
    raise FileNotFoundError(f"no checkpoint weights found under {path}")


def load_torch_state_dict(paths) -> Dict[str, np.ndarray]:
    """Read torch `.bin`/`.pth` shards and/or `.safetensors` shards (also
    accepts checkpoint directories, resolved via the HF index convention)."""
    import torch

    if isinstance(paths, str):
        paths = [paths]
    files = [f for p in paths for f in resolve_checkpoint_files(p)]
    sd: Dict[str, np.ndarray] = {}
    for p in files:
        if p.endswith(".safetensors"):
            # framework='pt' (not numpy): real checkpoints are bfloat16,
            # which numpy can't represent — go through torch cpu
            from safetensors import safe_open

            with safe_open(p, framework="pt") as f:
                for k in f.keys():
                    sd[k] = f.get_tensor(k).float().numpy()
            continue
        part = torch.load(p, map_location="cpu", weights_only=True)
        if "state_dict" in part:
            part = part["state_dict"]
        for k, v in part.items():
            sd[k] = v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
    return sd


def normalize_peft_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip peft wrappers: base_model.model. prefix, .base_layer, and map
    lora_A/lora_B adapter names."""
    out = {}
    for k, v in sd.items():
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer.", ".")
        k = re.sub(r"\.lora_A\.\w+\.weight$", ".lora_a", k)
        k = re.sub(r"\.lora_B\.\w+\.weight$", ".lora_b", k)
        out[k] = v
    return out


def deinterleave_wqkv(
    w: np.ndarray, num_heads: int, num_kv_heads: int, head_dim: int
) -> np.ndarray:
    """torch wqkv.weight [out, in] interleaved (h, gs, d) -> [out, in] with
    q|k|v block order (still torch orientation)."""
    g = num_heads // num_kv_heads
    in_dim = w.shape[1]
    w = w.reshape(num_kv_heads, g + 2, head_dim, in_dim)
    q = w[:, :g].reshape(num_heads * head_dim, in_dim)
    k = w[:, g].reshape(num_kv_heads * head_dim, in_dim)
    v = w[:, g + 1].reshape(num_kv_heads * head_dim, in_dim)
    return np.concatenate([q, k, v], axis=0)


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def normalize_hf_llama_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename HF Llama/Qwen2 decoder keys to the internlm2-style names this
    converter maps (reference dispatches all four LLM families,
    `configuration_internvl_chat.py:56-63`). q/k/v projections are fused into
    a single wqkv in the [q | k | v] row order — which IS this framework's
    de-interleaved layout, so the result is marked `wqkv_plain` to skip the
    InternLM2 de-interleave."""
    if not any(".self_attn.q_proj." in k for k in sd):
        return sd
    out: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    renames = (
        (".self_attn.o_proj.", ".attention.wo."),
        (".mlp.gate_proj.", ".feed_forward.w1."),
        (".mlp.up_proj.", ".feed_forward.w3."),
        (".mlp.down_proj.", ".feed_forward.w2."),
        (".input_layernorm.", ".attention_norm."),
        (".post_attention_layernorm.", ".ffn_norm."),
    )
    for key, v in sd.items():
        m = re.match(r"(.*)\.self_attn\.([qkv])_proj\.(weight|bias)$", key)
        if m:
            slot = qkv.setdefault(f"{m.group(1)}|{m.group(3)}", {})
            slot[m.group(2)] = v
            continue
        k = key
        k = k.replace("embed_tokens.weight", "tok_embeddings.weight")
        k = re.sub(r"(^|\.)lm_head\.weight$", r"\1output.weight", k)
        for old, new in renames:
            k = k.replace(old, new)
        out[k] = v
    for slot_key, parts in qkv.items():
        prefix, leaf = slot_key.split("|")
        fused = np.concatenate([parts["q"], parts["k"], parts["v"]], axis=0)
        out[f"{prefix}.attention.wqkv_plain.{leaf}"] = fused
    return out


def convert(
    sd: Dict[str, np.ndarray], config: AssessorConfig, strict: bool = False,
    stack: Tuple[str, ...] = ("vision_model", "language_model"),
) -> dict:
    """-> {"params": tree}, the towers named in `stack` with their layers
    stacked (`stack_layer_params`), any other tower unrolled (`layers_{i}`)."""
    sd = normalize_peft_keys(sd)
    sd = normalize_hf_llama_keys(sd)
    params: dict = {}
    unmapped = []
    llm = config.llm

    def put(path_str: str, v: np.ndarray):
        _set(params, tuple(path_str.split("/")), np.ascontiguousarray(v))

    for key, v in sd.items():
        k = key
        # ---------------- vision ----------------
        if k.startswith("vision_model."):
            k = k[len("vision_model."):]
            if k == "embeddings.class_embedding":
                put("vision_model/embeddings/class_embedding", v)
            elif k == "embeddings.position_embedding":
                put("vision_model/embeddings/position_embedding", v)
            elif k == "embeddings.patch_embedding.weight":
                put(
                    "vision_model/embeddings/patch_embedding/kernel",
                    v.transpose(2, 3, 1, 0),  # OIHW -> HWIO
                )
            elif k == "embeddings.patch_embedding.bias":
                put("vision_model/embeddings/patch_embedding/bias", v)
            else:
                m = re.match(r"encoder\.layers\.(\d+)\.(.*)", k)
                if not m:
                    unmapped.append(key)
                    continue
                i, rest = m.group(1), m.group(2)
                base = f"vision_model/layers_{i}"
                table = {
                    "attn.qkv.weight": (f"{base}/attn/qkv/base/kernel", "t"),
                    "attn.qkv.bias": (f"{base}/attn/qkv/base/bias", None),
                    "attn.proj.weight": (f"{base}/attn/proj/base/kernel", "t"),
                    "attn.proj.bias": (f"{base}/attn/proj/base/bias", None),
                    "attn.q_norm.weight": (f"{base}/attn/q_norm/weight", None),
                    "attn.k_norm.weight": (f"{base}/attn/k_norm/weight", None),
                    "mlp.fc1.weight": (f"{base}/mlp/fc1/base/kernel", "t"),
                    "mlp.fc1.bias": (f"{base}/mlp/fc1/base/bias", None),
                    "mlp.fc2.weight": (f"{base}/mlp/fc2/base/kernel", "t"),
                    "mlp.fc2.bias": (f"{base}/mlp/fc2/base/bias", None),
                    "norm1.weight": (f"{base}/norm1/weight", None),
                    "norm1.bias": (f"{base}/norm1/bias", None),
                    "norm2.weight": (f"{base}/norm2/weight", None),
                    "norm2.bias": (f"{base}/norm2/bias", None),
                    "ls1": (f"{base}/ls1", None),
                    "ls2": (f"{base}/ls2", None),
                    "attn.qkv.lora_a": (f"{base}/attn/qkv/lora_a", "t"),
                    "attn.qkv.lora_b": (f"{base}/attn/qkv/lora_b", "t"),
                    "attn.proj.lora_a": (f"{base}/attn/proj/lora_a", "t"),
                    "attn.proj.lora_b": (f"{base}/attn/proj/lora_b", "t"),
                    "mlp.fc1.lora_a": (f"{base}/mlp/fc1/lora_a", "t"),
                    "mlp.fc1.lora_b": (f"{base}/mlp/fc1/lora_b", "t"),
                    "mlp.fc2.lora_a": (f"{base}/mlp/fc2/lora_a", "t"),
                    "mlp.fc2.lora_b": (f"{base}/mlp/fc2/lora_b", "t"),
                }
                if rest in table:
                    tgt, op = table[rest]
                    put(tgt, v.T if op == "t" else v)
                else:
                    unmapped.append(key)
        # ---------------- language model ----------------
        elif k.startswith("language_model."):
            k = k[len("language_model."):]
            k = k.replace("model.", "", 1) if k.startswith("model.") else k
            if k == "tok_embeddings.weight":
                put("language_model/tok_embeddings/embedding", v)
            elif k == "norm.weight":
                put("language_model/norm/weight", v)
            elif k == "output.weight":
                put("language_model/output/kernel", v.T)
            # Phi-3 alt backbone (reference `internvl/model/phi3/` — HF
            # layout: fused plain-concat qkv_proj / gate_up_proj)
            elif k == "embed_tokens.weight":
                put("language_model/embed_tokens/embedding", v)
            elif k == "lm_head.weight":
                put("language_model/lm_head/kernel", v.T)
            elif re.match(
                r"layers\.\d+\.(self_attn\.(qkv_proj|o_proj)|mlp\.(gate_up_proj|down_proj))\.weight",
                k,
            ):
                m = re.match(r"layers\.(\d+)\.(.*)\.weight", k)
                i, mod = m.group(1), m.group(2).replace(".", "/")
                put(f"language_model/layers_{i}/{mod}/base/kernel", v.T)
            elif re.match(
                r"layers\.\d+\.(input_layernorm|post_attention_layernorm)\.weight",
                k,
            ):
                m = re.match(r"layers\.(\d+)\.(.*)\.weight", k)
                put(f"language_model/layers_{m.group(1)}/{m.group(2)}/weight", v)
            else:
                m = re.match(r"layers\.(\d+)\.(.*)", k)
                if not m:
                    unmapped.append(key)
                    continue
                i, rest = m.group(1), m.group(2)
                base = f"language_model/layers_{i}"
                if rest == "attention.wqkv.weight":
                    w = deinterleave_wqkv(
                        v, llm.num_attention_heads, llm.num_key_value_heads,
                        llm.head_dim,
                    )
                    put(f"{base}/attention/wqkv/base/kernel", w.T)
                elif rest == "attention.wqkv.bias":
                    b = deinterleave_wqkv(
                        v[:, None], llm.num_attention_heads,
                        llm.num_key_value_heads, llm.head_dim,
                    )[:, 0]
                    put(f"{base}/attention/wqkv/base/bias", b)
                elif rest == "attention.wqkv_plain.weight":
                    # already [q | k | v] row order (HF Llama/Qwen2 fused
                    # here) — no de-interleave
                    put(f"{base}/attention/wqkv/base/kernel", v.T)
                elif rest == "attention.wqkv_plain.bias":
                    put(f"{base}/attention/wqkv/base/bias", v)
                elif rest == "attention.wo.bias":
                    put(f"{base}/attention/wo/base/bias", v)
                elif rest == "attention.wqkv.lora_a":
                    put(f"{base}/attention/wqkv/lora_a", v.T)
                elif rest == "attention.wqkv.lora_b":
                    w = deinterleave_wqkv(
                        v, llm.num_attention_heads, llm.num_key_value_heads,
                        llm.head_dim,
                    )
                    put(f"{base}/attention/wqkv/lora_b", w.T)
                elif rest == "attention.wo.weight":
                    put(f"{base}/attention/wo/base/kernel", v.T)
                elif rest in ("attention.wo.lora_a", "attention.wo.lora_b"):
                    put(f"{base}/attention/wo/{rest.split('.')[-1]}", v.T)
                elif re.match(r"feed_forward\.w[123]\.(weight|lora_a|lora_b)", rest):
                    wname = rest.split(".")[1]
                    leaf = rest.split(".")[-1]
                    tgt = (
                        f"{base}/feed_forward/{wname}/base/kernel"
                        if leaf == "weight"
                        else f"{base}/feed_forward/{wname}/{leaf}"
                    )
                    put(tgt, v.T)
                elif rest == "attention_norm.weight":
                    put(f"{base}/attention_norm/weight", v)
                elif rest == "ffn_norm.weight":
                    put(f"{base}/ffn_norm/weight", v)
                else:
                    unmapped.append(key)
        # ---------------- projectors & heads ----------------
        elif k.startswith("mlp1.") or k.startswith("motion_mlp."):
            mod = k.split(".")[0]
            idx, leaf = k.split(".")[1], k.split(".")[2]
            # torch Sequential: 0 = LayerNorm, 1 = Linear, 3 = Linear
            sub = {"0": "ln", "1": "fc1", "3": "fc2"}[idx]
            if sub == "ln":
                put(f"{mod}/ln/{'scale' if leaf == 'weight' else 'bias'}", v)
            else:
                put(
                    f"{mod}/{sub}/{'kernel' if leaf == 'weight' else 'bias'}",
                    v.T if leaf == "weight" else v,
                )
        elif k.startswith("mlpscore."):
            m = re.match(r"mlpscore\.fc(\d)\.(weight|bias)", k)
            if m:
                put(
                    f"mlpscore/fc{m.group(1)}/"
                    f"{'kernel' if m.group(2) == 'weight' else 'bias'}",
                    v.T if m.group(2) == "weight" else v,
                )
            else:
                unmapped.append(key)
        # ---------------- slowfast ----------------
        elif k.startswith("slowfast_model."):
            tgt = map_slowfast_key(k)
            if tgt is None:
                unmapped.append(key)
            elif tgt[1] != "skip":
                path, op = tgt
                put(
                    f"slowfast_model/{path}",
                    v.transpose(2, 3, 4, 1, 0) if op == "conv" else v,
                )
        else:
            unmapped.append(key)

    if unmapped:
        if strict:
            raise ValueError(
                f"{len(unmapped)} unmapped checkpoint keys, e.g. {unmapped[:8]}"
            )
        logger.warning("%d unmapped keys, e.g. %s", len(unmapped), unmapped[:8])
    for tower in stack:
        if tower in params:
            params[tower] = stack_layer_params(params[tower])
    return {"params": params}


def stack_layer_params(tree: Any) -> Any:
    """{... 'layers_0': T0, 'layers_1': T1 ...} -> {... 'layers': stacked},
    at every level (`aigv_assessor_tpu/utils/stacking.stack_layer_params`)."""
    if not isinstance(tree, dict):
        return tree
    idx: Dict[int, Any] = {}
    rest: Dict[str, Any] = {}
    for key, val in tree.items():
        m = _LAYER_RE.match(str(key))
        if m:
            idx[int(m.group(1))] = stack_layer_params(val)
        else:
            rest[key] = stack_layer_params(val)
    if idx:
        n = max(idx) + 1
        missing = [i for i in range(n) if i not in idx]
        if missing:
            raise ValueError(f"missing layer indices {missing} while stacking")
        rest["layers"] = _stack([idx[i] for i in range(n)])
    return rest


def _stack(subtrees: List[Any]) -> Any:
    """Keys sorted, as `jax.tree_util.tree_map` rebuilds JAX's stacked tree."""
    first = subtrees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in subtrees]) for k in sorted(first)}
    return np.stack([np.asarray(t) for t in subtrees], axis=0)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def main(argv=None) -> None:
    """The JAX tool's command line: a reference checkpoint to a flax
    `params.msgpack`."""
    from aigv_assessor_torch.utils import flax_msgpack

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--torch_ckpt", nargs="+", required=True,
        help="weight files (.bin/.pth/.safetensors) or a checkpoint "
             "directory (sharded safetensors + index resolved HF-style)",
    )
    ap.add_argument("--config", required=True, help="reference config.json")
    ap.add_argument("--out", default="params.msgpack")
    ap.add_argument(
        "--strict", action="store_true",
        help="fail (instead of warn) on unmapped checkpoint keys",
    )
    args = ap.parse_args(argv)

    config = AssessorConfig.from_json(args.config)
    scanned = (("vision_model", config.vision.scan_layers),
               ("language_model", config.llm.scan_layers))
    tree = convert(load_torch_state_dict(args.torch_ckpt), config, strict=args.strict,
                   stack=tuple(tower for tower, scan in scanned if scan))
    # flax's `to_bytes`, as the JAX tool writes: maps in the tree's order
    flax_msgpack.save(args.out, tree, sort_keys=False)
    n = sum(np.asarray(leaf).size for leaf in _leaves(tree))
    print(f"wrote {args.out}: {n/1e6:.1f}M params")


# pytorchvideo slowfast_r50 module-name mapping -------------------------------

_BN_LEAF = {
    "weight": "scale",
    "bias": "bias",
    "running_mean": "mean",
    "running_var": "var",
}


def map_slowfast_key(key: str):
    """pytorchvideo `Net` names (blocks.{i}...) -> this repo's SlowFastR50
    module tree. The reference wraps stages 0-4 of the hub model
    (`modeling_internvl_chat.py:145-157`), so keys may be prefixed
    slowfast_model.feature_extraction.{i}."""
    k = key.replace("slowfast_model.", "")
    k = re.sub(r"^feature_extraction\.", "blocks.", k)
    m = re.match(r"blocks\.(\d)\.(.*)", k)
    if not m:
        return None
    block, rest = int(m.group(1)), m.group(2)

    def bn(path, leaf):
        if leaf == "num_batches_tracked":  # torch BN counter: no flax analog
            return ("", "skip")
        return (f"{path}/bn/{_BN_LEAF[leaf]}", "plain")

    if block == 0:  # stems + fusion
        m2 = re.match(r"multipathway_blocks\.(\d)\.(conv|norm)\.(\w+)", rest)
        if m2:
            pathway = "slow_stem" if m2.group(1) == "0" else "fast_stem"
            if m2.group(2) == "conv":
                return (f"{pathway}/conv/conv/kernel", "conv")
            return bn(f"{pathway}/conv", m2.group(3))
        m2 = re.match(r"multipathway_fusion\.conv_fast_to_slow\.(\w+)", rest)
        if m2:
            return (f"fuse_stem/conv/conv/kernel", "conv")
        m2 = re.match(r"multipathway_fusion\.norm\.(\w+)", rest)
        if m2:
            return bn("fuse_stem/conv", m2.group(1))
        return None

    stage = block + 1  # blocks.1 -> res2
    m2 = re.match(r"multipathway_blocks\.(\d)\.res_blocks\.(\d+)\.(.*)", rest)
    if m2:
        pathway = "slow" if m2.group(1) == "0" else "fast"
        j, sub = m2.group(2), m2.group(3)
        base = f"{pathway}_res{stage}/block_{j}"
        m3 = re.match(r"branch1_conv\.(\w+)", sub)
        if m3:
            return (f"{base}/shortcut/conv/kernel", "conv")
        m3 = re.match(r"branch1_norm\.(\w+)", sub)
        if m3:
            return bn(f"{base}/shortcut", m3.group(1))
        m3 = re.match(r"branch2\.conv_([abc])\.(\w+)", sub)
        if m3:
            return (f"{base}/conv_{m3.group(1)}/conv/kernel", "conv")
        m3 = re.match(r"branch2\.norm_([abc])\.(\w+)", sub)
        if m3:
            return bn(f"{base}/conv_{m3.group(1)}", m3.group(2))
        return None
    m2 = re.match(r"multipathway_fusion\.conv_fast_to_slow\.(\w+)", rest)
    if m2:
        return (f"fuse_res{stage}/conv/conv/kernel", "conv")
    m2 = re.match(r"multipathway_fusion\.norm\.(\w+)", rest)
    if m2:
        return bn(f"fuse_res{stage}/conv", m2.group(1))
    return None


if __name__ == "__main__":
    main()
