"""Weights: the JAX parameter tree mapped onto the port's `state_dict`, and
seeded random weights made on the device.

`state_dict_from_jax` takes the JAX package's parameter tree with numpy
leaves (what `jax.device_get(model.init(...))` returns) and gives the
`state_dict` of the port's `AIGVAssessor` for the same config:

- `layers` stacked by scan-over-layers (leading [L] axis) become one entry
  per layer of a `ModuleList` (`layers.0`, `layers.1`, ...);
- the `base` level of the JAX LoRA wrappers is dropped; the adapter leaves
  `lora_a` [in, r] and `lora_b` [r, out] keep their names and layout;
- flax `Dense` kernels [in, out] become `nn.Linear` weights [out, in];
  head-major projections keep the JAX head order, which is the order of the
  Linear's output features;
- conv kernels HWIO / DHWIO become OIHW / OIDHW;
- `embedding` and the flax LayerNorm's `scale` become `weight`;
- a W8A8 or int8 tree's `kernel_int8` [in, out] becomes the int8 `weight`
  [out, in] of a `W8A8Linear` / `Int8Linear`, and its fp32 `kernel_scale`
  becomes `weight_scale`;
- an int4 tree's `kernel_int4` [ceil(in/2), out] becomes the `weight`
  [out, ceil(in/2)] of an `Int4Linear` (the same bytes, transposed), its
  `kernel_scale4` becomes `weight_scale`, and the `kernel_in_dim` scalars
  are dropped, as `strip_int4_meta` drops them.

Any key left over or missing, or any shape that differs, raises.

`jax_paths` is the inverse name map: each parameter or buffer name of the
port's model -> its JAX path and layer index, which the LoRA artifact
(`train/checkpoint.py`) and the leaf-by-leaf tests are keyed by.

`quantize_for_serving` makes the W8A8, int8 or int4 weights from float ones,
as the JAX `quantize_for_serving(w8a8=True | int8=True | int4=True)` does,
and `serving_precision` the precision that call returns beside them,
`kv_int8` included.

`init_random_` fills a model from a seed, each tensor drawn in fp32 and
stored in its own dtype, so a model can be built straight in bf16;
`init_lora_` and `init_score_head_` draw the adapters and the score head as
the JAX modules initialise them.

`load_reference_checkpoint` reads a reference-format checkpoint from disk
(sharded safetensors with their index, or torch `.bin` / `.pth` shards)
through `tools/convert_weights.convert` and `state_dict_from_jax`: fp32
weights for `AIGVAssessor(config)`. The JAX package's own `params.msgpack`
needs flax, which the port does not use.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.assessor import AIGVAssessor, ScoreMLP
from aigv_assessor_torch.models.lora import (
    Int4Linear,
    Int8Linear,
    LoRALinear,
    W8A8Linear,
    is_lora_param,
)
from aigv_assessor_torch.models.motion import FrozenBatchNorm
from aigv_assessor_torch.models.vit import InternVisionEncoderLayer
from aigv_assessor_torch.ops.norms import LayerNorm, RMSNorm
from aigv_assessor_torch.ops.int8_matmul import quantize_kernel_int4
from aigv_assessor_torch.ops.w8a8 import quantize_kernel

INIT_STD = 0.02  # the configs' initializer_range


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.array(x)  # a writable copy: device_get hands out read-only arrays
    if x.dtype.name == "bfloat16":  # ml_dtypes, which torch.from_numpy rejects
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _convert_leaf(path: Tuple[str, ...], x: np.ndarray) -> Tuple[str, torch.Tensor]:
    path = tuple(p for p in path if p != "base")
    name = path[-1]
    t = _to_torch(x)
    if name in ("kernel_scale", "kernel_scale4"):
        name = "weight_scale"
    elif name in ("kernel", "kernel_int8", "kernel_int4"):
        name = "weight"
        if t.ndim == 2:  # Dense [in, out] -> Linear [out, in]
            t = t.t()
        elif t.ndim == 4:  # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1)
        elif t.ndim == 5:  # DHWIO -> OIDHW
            t = t.permute(4, 3, 0, 1, 2)
    elif name == "embedding":
        name = "weight"
    elif name == "scale" and path[-2] == "ln":  # flax LayerNorm
        name = "weight"
    return ".".join(path[:-1] + (name,)), t.contiguous()


def expected_shapes(
    config: AssessorConfig, precision: Precision = Precision()
) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the port model's state_dict, built without memory."""
    with torch.device("meta"):
        model = AIGVAssessor(config, precision)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def state_dict_from_jax(
    params: Mapping[str, Any], config: AssessorConfig, precision: Precision = Precision()
) -> Dict[str, torch.Tensor]:
    """The port's state_dict for `AIGVAssessor(config, precision)`; a
    quantized tree (JAX `quantize_for_serving(w8a8=True | int8=True |
    int4=True)`) needs the precision that call returns."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, x in _flatten(tree):
        if path[-1] == "kernel_in_dim":  # int4 bookkeeping, no model parameter
            continue
        if "layers" in path:  # scan-stacked: leading [L] axis
            i = path.index("layers")
            for layer in range(np.shape(x)[0]):
                key, t = _convert_leaf(path[: i + 1] + (str(layer),) + path[i + 1 :], x[layer])
                out[key] = t
        else:
            key, t = _convert_leaf(path, x)
            out[key] = t
    want = expected_shapes(config, precision)
    missing = sorted(set(want) - set(out))
    unused = sorted(set(out) - set(want))
    if missing or unused:
        raise KeyError(f"JAX params do not match the port model: missing {missing}, unused {unused}")
    bad = {k: (tuple(out[k].shape), want[k]) for k in want if tuple(out[k].shape) != want[k]}
    if bad:
        raise ValueError(f"shape mismatch (got, want): {bad}")
    return out


# tower projections: a JAX `LoRADense`, whose dense layer sits under `base`
_TOWER_PROJECTIONS = {
    "vision_model": ("qkv", "proj", "fc1", "fc2"),
    "language_model": ("wqkv", "wo", "w1", "w2", "w3"),
}


def jax_paths(model: torch.nn.Module) -> Dict[str, Tuple[str, Optional[int]]]:
    """{state_dict name: (JAX path joined by '/', layer index or None)} for
    every parameter and buffer of the port's model: the inverse of
    `state_dict_from_jax`'s renaming. A leaf of `layers.<i>` maps to the
    scan-stacked JAX leaf under `layers` and the index i of its leading
    axis."""
    out: Dict[str, Tuple[str, Optional[int]]] = {}
    for name in model.state_dict():
        parts = name.split(".")
        module = model.get_submodule(".".join(parts[:-1])) if len(parts) > 1 else model
        leaf, layer, path = parts[-1], None, []
        for i, p in enumerate(parts[:-1]):
            if i and parts[i - 1] == "layers" and p.isdigit():
                layer = int(p)
            else:
                path.append(p)
        if isinstance(module, Int4Linear):
            leaf = {"weight": "kernel_int4", "weight_scale": "kernel_scale4"}.get(leaf, leaf)
        elif isinstance(module, (W8A8Linear, Int8Linear)):
            leaf = {"weight": "kernel_int8", "weight_scale": "kernel_scale"}.get(leaf, leaf)
        elif isinstance(module, (torch.nn.Linear, LoRALinear, torch.nn.Conv2d, torch.nn.Conv3d)):
            leaf = "kernel" if leaf == "weight" else leaf
        elif isinstance(module, torch.nn.Embedding):
            leaf = "embedding"
        elif isinstance(module, torch.nn.LayerNorm):  # flax LayerNorm
            leaf = "scale" if leaf == "weight" else leaf
        if (layer is not None and path[-1] in _TOWER_PROJECTIONS.get(path[0], ())
                and leaf not in ("lora_a", "lora_b")):
            path.append("base")
        out[name] = ("/".join(path + [leaf]), layer)
    return out


def serving_precision(
    precision: Precision = Precision(),
    *,
    w8a8: bool = False,
    int8: bool = False,
    int4: bool = False,
    kv_int8: bool = False,
) -> Precision:
    """The precision the JAX `quantize_for_serving` hands back for these
    flags: each flag adds to what `precision` already says; int4 goes before
    int8 when both are set; `kv_int8` composes with every weight mode; W8A8
    with a weight-only mode raises ValueError."""
    w8a8 = w8a8 or precision.w8a8
    int4 = int4 or precision.int4_weights
    int8 = (int8 or precision.int8_weights) and not int4
    return dataclasses.replace(
        precision, w8a8=w8a8, int8_weights=int8, int4_weights=int4,
        kv_int8=kv_int8 or precision.kv_int8)


@torch.no_grad()
def quantize_for_serving(
    state_dict: Mapping[str, torch.Tensor],
    config: AssessorConfig,
    *,
    int8: bool = False,
    int4: bool = False,
) -> Dict[str, torch.Tensor]:
    """Quantized serving weights from the fp32 state_dict of
    `AIGVAssessor(config)`: the state_dict of the same model under
    `Precision(w8a8=True)`, or with `int8` / `int4` under
    `Precision(int8_weights=True)` / `(int4_weights=True)` (int4 first when
    both are set, as in the JAX package).

    W8A8 quantizes the weights the W8A8 model holds as `W8A8Linear`s, the
    set JAX's `quantize_tree(only_base=True)` picks over both towers: the
    ViT's qkv, proj, fc1, fc2 and InternLM2's wqkv, wo, w1, w2, w3 in every
    layer. The LM head and everything outside the towers stay float.

    int8 / int4 quantize what `quantize_tree` / `quantize_tree_int4` pick
    with `scope="language_model"` and their default `min_size` of 4096 on
    any config at least as wide as `LLMConfig.tiny()`: every dense weight
    under `language_model`, the LM head included, the embedding excluded.
    These are the weights the weight-only model holds as `Int8Linear` /
    `Int4Linear`; it has no float form of a decoder projection.

    The weights must be fp32: quantizing bf16-rounded copies adds error, and
    JAX quantizes before it casts."""
    if not (int8 or int4):
        want = expected_shapes(config, Precision(w8a8=True))
        quantize = quantize_kernel
    else:
        want = expected_shapes(config, Precision(int4_weights=int4, int8_weights=not int4))
        quantize = quantize_kernel_int4 if int4 else quantize_kernel
    prefixes = [key[: -len("_scale")] for key in want if key.endswith(".weight_scale")]
    out = dict(state_dict)
    for prefix in prefixes:  # "<module>.weight"
        w = out[prefix]
        if w.dtype != torch.float32:
            raise TypeError(f"{prefix} is {w.dtype}: quantize from the fp32 weights")
        out[prefix], out[prefix + "_scale"] = quantize(w)
    return out


def load_reference_checkpoint(path: str, config: AssessorConfig) -> Dict[str, torch.Tensor]:
    """fp32 state_dict of `AIGVAssessor(config)` from a reference-format
    checkpoint (a directory or weight files): the JAX converter's name map
    (`tools/convert_weights.convert`), then `state_dict_from_jax`. Raises
    ValueError for a flax `params.msgpack`, FileNotFoundError where there are
    no weights."""
    from aigv_assessor_torch.tools.convert_weights import (
        convert, load_torch_state_dict, resolve_checkpoint_files)

    flax_note = (f"{path}: a flax params.msgpack needs flax, which the port does not use; "
                 "load the reference checkpoint (safetensors or .bin) it was converted from")
    if os.path.isdir(path):
        try:
            files = resolve_checkpoint_files(path)
        except FileNotFoundError:
            if os.path.exists(os.path.join(path, "params.msgpack")):
                raise ValueError(flax_note) from None
            raise
    else:
        files = [path]
    if any(f.endswith(".msgpack") for f in files):
        raise ValueError(flax_note)
    tree = convert(load_torch_state_dict(files), config)
    return {k: v.float() for k, v in state_dict_from_jax(tree, config).items()}


@torch.no_grad()
def init_random_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every weight in place from a seeded generator on the model's
    device: normal(0, INIT_STD) for weights and biases, norms at weight 1 and
    bias 0, frozen batch norm at the identity, LayerScale at the vision
    config's `initializer_factor`. Random rather than zero, so that attention
    is not uniform and a masking fault shows. Adapter leaves are skipped
    (`init_lora_` draws them), so one seed gives a model the same base
    weights with and without adapters.

    Each tensor is drawn in fp32 from the same generator sequence whatever
    its dtype, and stored rounded to the parameter's own dtype: a model held
    in bf16 gets, bit for bit, the fp32 draw cast to bf16, and never holds
    more than one fp32 tensor at a time."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if is_lora_param(name):
            continue
        if p.dtype == torch.float32:
            p.normal_(0.0, INIT_STD, generator=gen)
        else:
            p.copy_(torch.empty(p.shape, dtype=torch.float32, device=device).normal_(
                0.0, INIT_STD, generator=gen))
    for m in model.modules():
        if isinstance(m, (LayerNorm, RMSNorm, torch.nn.LayerNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.scale.fill_(1.0)
            m.var.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
        elif isinstance(m, InternVisionEncoderLayer):
            m.ls1.fill_(m.initializer_factor)
            m.ls2.fill_(m.initializer_factor)
    return model


@torch.no_grad()
def init_lora_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw every adapter as the JAX `LoRADense` initialises it: `lora_a`
    uniform with variance (1 / r) / fan_in, `lora_b` zeros, so the model
    computes the base function until `lora_b` moves."""
    gen: Optional[torch.Generator] = None
    for m in model.modules():
        if not isinstance(m, LoRALinear):
            continue
        if gen is None:
            gen = torch.Generator(device=m.lora_a.device).manual_seed(seed)
        fan_in, r = m.lora_a.shape
        bound = math.sqrt(3.0 * (1.0 / r) / fan_in)
        m.lora_a.uniform_(-bound, bound, generator=gen)
        m.lora_b.zero_()
    return model


@torch.no_grad()
def init_score_head_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw the score head as the JAX `ScoreMLP` initialises it: weights
    uniform in (-0.1, 0.1), biases zero."""
    for m in model.modules():
        if isinstance(m, ScoreMLP):
            gen = torch.Generator(device=m.fc1.weight.device).manual_seed(seed)
            for i in range(m.num_layers):
                fc = getattr(m, f"fc{i + 1}")
                fc.weight.uniform_(-0.1, 0.1, generator=gen)
                fc.bias.zero_()
    return model
