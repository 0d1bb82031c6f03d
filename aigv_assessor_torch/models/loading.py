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

`init_random_` fills a model from a seed and `load_weights_` from a float
state_dict (which may lack the score head and the adapters, then drawn by
`init_score_head_` and `init_lora_` as the JAX modules initialise them). Both
take each base tensor in fp32, one at a time, in the order of the float
model's `named_parameters`, and store it in the model's own form: rounded to
a parameter's dtype, or quantized straight into a quantized layer's int8
weight and fp32 scale. So a model is built in bf16 or in a quantized
precision without an fp32 copy of it, and one seed gives the same values in
every precision.

`load_reference_checkpoint` reads a reference-format checkpoint from disk
(sharded safetensors with their index, or torch `.bin` / `.pth` shards)
through `tools/convert_weights.convert` and `state_dict_from_jax`: fp32
weights for `AIGVAssessor(config)`.

The JAX package's own parameter tree goes to and from disk in two
containers, chosen by the file's suffix (`load_jax_params`,
`save_jax_params`): flax's msgpack (`params.msgpack`, read and written
without flax by `utils/flax_msgpack.py`), or safetensors holding the same
tree flat, keyed by the '/'-joined JAX paths (`params.safetensors`, the
layout of `train/checkpoint.save_trainable_weights`). `jax_tree` is the
inverse of `state_dict_from_jax`: a model's tree in the JAX layout.

`weights_from_jax` takes a tree as JAX's `quantize_for_serving` finds it,
float or holding stored `kernel_int8` / `kernel_int4` leaves
(`tools/convert_to_int8.py`), and keeps each stored kernel quantized as a
`StoredKernel` under its float weight's name. `load_weights_` then applies
JAX's rules (`aigv_assessor_tpu/models/loading.py:120-180`) one tensor at
a time: a stored kernel of the kind the layer holds (int8 in an
`Int8Linear`, int4 in an `Int4Linear`) is copied bit for bit; any other
layer takes it dequantized to fp32, then quantized or rounded as a float
weight. So `--int8` serves an int8 file as it is, `--int4` an int8 file
through dequantize then int4, `--w8a8` any stored kernel through
dequantize then JAX's W8A8 pick, and a float mode dequantizes to the
compute dtype; no build holds an fp32 copy of the model.

`shard_for_inference` lays a built serving model out over the ranks of a
process group with the training sharding rules
(`parallel/sharding.shard_params`; by default every rank on `fsdp`, as
JAX's `MeshConfig.auto(fsdp=True)`), where JAX lays its parameters over a
mesh; with `mesh_config=MeshConfig(tensor=...)` the float towers split by
heads over `tensor` as JAX splits them, quantized builds stay whole on
every rank of the axis. Each rank then runs `score_perspectives` or `generate` on its rows of
the batch, under `torch.no_grad`: FSDP2's all-gather cannot run under
`torch.inference_mode` (`generate` picks the right one itself).
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
    LORA_LEAVES,
    AdaptedLinear,
    Int4Linear,
    Int8Linear,
    LoRALinear,
    QuantizedLinear,
    W8A8Linear,
    is_lora_param,
)
from aigv_assessor_torch.models.motion import FrozenBatchNorm
from aigv_assessor_torch.models.vit import InternVisionEncoderLayer
from aigv_assessor_torch.ops import int8_matmul
from aigv_assessor_torch.ops.norms import LayerNorm, RMSNorm

INIT_STD = 0.02  # the configs' initializer_range


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flatten_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """{'/'-joined path: leaf} of a nested tree, in its order (flax's
    `flatten_dict`; empty subtrees dropped)."""
    return {"/".join(path): x for path, x in _flatten(tree)}


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The nested tree of `flatten_tree`'s output."""
    tree: Dict[str, Any] = {}
    for key, x in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


def jax_params_file(directory: str) -> Optional[str]:
    """The JAX tree a checkpoint directory holds: `params.msgpack`, else
    `params.safetensors`, else None."""
    for name in ("params.msgpack", "params.safetensors"):
        if os.path.isfile(os.path.join(directory, name)):
            return os.path.join(directory, name)
    return None


def load_jax_params(path: str) -> Dict[str, Any]:
    """A JAX parameter tree (tensor leaves) from `path`: a `.msgpack` file
    (flax's format), a `.safetensors` file (the tree flat, '/'-joined keys),
    or a directory's `jax_params_file`. FileNotFoundError where there is
    none."""
    if os.path.isdir(path):
        found = jax_params_file(path)
        if found is None:
            raise FileNotFoundError(f"no params.msgpack or params.safetensors under {path}")
        path = found
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return unflatten_tree(load_file(path))
    if path.endswith(".msgpack"):
        from aigv_assessor_torch.utils import flax_msgpack

        return flax_msgpack.load(path)
    raise ValueError(f"{path}: a JAX parameter tree is a .msgpack or a .safetensors file")


def save_jax_params(path: str, tree: Mapping[str, Any]) -> None:
    """Write a tree as `load_jax_params` reads it, the container by the
    suffix: `.msgpack` (flax's bytes) or `.safetensors` (flat; a `None`
    leaf, which flax writes as nil, is left out)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file

        flat = {k: _to_torch(x).contiguous() for k, x in flatten_tree(tree).items()
                if x is not None}
        save_file(flat, path)
    elif path.endswith(".msgpack"):
        from aigv_assessor_torch.utils import flax_msgpack

        flax_msgpack.save(path, tree)
    else:
        raise ValueError(f"{path}: a JAX parameter tree is a .msgpack or a .safetensors file")


@dataclasses.dataclass
class StoredKernel:
    """A dense kernel a tree stores quantized, in the JAX layout:
    `kernel_int8` + `kernel_scale` (bits 8) or `kernel_int4` + `kernel_scale4`
    (+ `kernel_in_dim`) (bits 4). `q` is int8 [..., in or ceil(in / 2),
    out], `scale` fp32 [..., out]; a leading axis is the stacked layers."""

    bits: int
    q: torch.Tensor
    scale: torch.Tensor
    in_dim: int

    def __len__(self) -> int:
        return self.q.shape[0]

    def __getitem__(self, layer: int) -> "StoredKernel":
        return StoredKernel(self.bits, self.q[layer], self.scale[layer], self.in_dim)

    @property
    def shape(self) -> Tuple[int, int]:
        """The float weight's [out, in]."""
        return (self.q.shape[-1], self.in_dim)

    def weight(self) -> torch.Tensor:
        """The int8 weight of an `Int8Linear` / `Int4Linear`: `q`
        transposed, [out, in] or [out, ceil(in / 2)]."""
        return self.q.t().contiguous()

    def dequantize(self, device) -> torch.Tensor:
        """fp32 [out, in] on `device`, as JAX's `dequantize_kernel` /
        `dequantize_kernel_int4` compute it."""
        q, scale = self.weight().to(device), self.scale.to(device)
        if self.bits == 4:
            return int8_matmul.dequantize_kernel_int4(q, scale, self.in_dim)
        return int8_matmul.dequantize_kernel(q, scale)


def stored_kernels(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The tree (under `params` if it has that level) with each stored
    quantized kernel's leaves replaced by one `kernel` leaf holding a
    `StoredKernel`; a float tree comes back as it is."""
    flat = flatten_tree(params.get("params", params))
    out: Dict[str, Any] = {}
    for key, x in flat.items():
        prefix, _, leaf = key.rpartition("/")
        at = f"{prefix}/" if prefix else ""
        if leaf == "kernel_int8":
            out[at + "kernel"] = StoredKernel(8, _to_torch(x), _to_torch(flat[at + "kernel_scale"]),
                                              x.shape[-2])
        elif leaf == "kernel_int4":
            dim = flat.get(at + "kernel_in_dim")
            out[at + "kernel"] = StoredKernel(4, _to_torch(x), _to_torch(flat[at + "kernel_scale4"]),
                                              2 * x.shape[-2] if dim is None else int(dim))
        elif leaf not in ("kernel_scale", "kernel_scale4", "kernel_in_dim"):
            out[key] = x
    return unflatten_tree(out)


def weights_from_jax(params: Mapping[str, Any], config: AssessorConfig,
                     parts: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """The weights of the float `AIGVAssessor(config)` from a JAX tree, for
    `load_weights_`: `state_dict_from_jax` of `stored_kernels(params)`, each
    stored quantized kernel left a `StoredKernel` under its weight's name,
    every other leaf in its stored dtype. `parts`: as `state_dict_from_jax`'s."""
    return state_dict_from_jax(stored_kernels(params), config, parts=parts)


def jax_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """`{"params": tree}` of `model` in the JAX layout, tensors on the CPU:
    the inverse of `state_dict_from_jax` (a dense weight [out, in] back to a
    kernel [in, out], convolutions to HWIO / DHWIO, layers stacked on a
    leading axis, a quantized weight to `kernel_int8` / `kernel_int4`)."""
    state = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    return {"params": unflatten_tree(jax_leaves(model, state))}


# a port weight's dims -> the JAX kernel's: dense [out, in] -> [in, out],
# OIHW -> HWIO, OIDHW -> DHWIO; and back
_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
_TO_PORT = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _relayout(perms, path: str, t: torch.Tensor, stacked: bool) -> torch.Tensor:
    if path.rpartition("/")[2] not in ("kernel", "kernel_int8", "kernel_int4"):
        return t
    lead = 1 if stacked else 0
    perm = perms.get(t.ndim - lead)
    return t if perm is None else t.permute(*range(lead), *(lead + d for d in perm))


def jax_layout(path: str, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    """A port tensor in the layout of the JAX leaf at `path` (a view): a
    dense weight [out, in] as a kernel [in, out], convolutions OIHW / OIDHW
    as HWIO / DHWIO; any other leaf as it is. `stacked`: `t` holds layers
    on a leading axis."""
    return _relayout(_TO_JAX, path, t, stacked)


def port_layout(path: str, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    """The inverse of `jax_layout`."""
    return _relayout(_TO_PORT, path, t, stacked)


def _by_path(model: torch.nn.Module, names) -> Dict[str, Dict[Optional[int], str]]:
    """{JAX path: {layer (None outside the layers): state_dict name}} of
    `names`, in the model's order."""
    out: Dict[str, Dict[Optional[int], str]] = {}
    for name, (path, layer) in jax_paths(model).items():
        if name in names:
            out.setdefault(path, {})[layer] = name
    return out


def jax_leaves(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor],
               device=None, out=None) -> Dict[str, torch.Tensor]:
    """{JAX path: tensor} of `tensors` ({state_dict name: tensor}, e.g. the
    model's state or one of its optimizer moments) in the JAX layout
    (`jax_layout`), the layers of a stack stacked on a leading axis, in
    the model's order. Each leaf is built on `device` (default: where its
    tensors are; a card transposes far faster than the host) and moved to
    `out` (default: left there), one leaf at a time."""
    flat: Dict[str, torch.Tensor] = {}
    for path, by_layer in _by_path(model, tensors).items():
        if None in by_layer:
            t = jax_layout(path, tensors[by_layer[None]].to(device))
        else:
            t = jax_layout(path, torch.stack([tensors[by_layer[i]].to(device)
                                              for i in range(len(by_layer))]), stacked=True)
        flat[path] = t.contiguous().to(out)
    return flat


def port_leaves(model: torch.nn.Module, leaves: Mapping[str, torch.Tensor],
                device=None, out=None) -> Dict[str, torch.Tensor]:
    """The inverse of `jax_leaves`: {state_dict name: tensor} of the JAX
    leaves of `model` that `leaves` ({JAX path: tensor}) holds, in the
    port's layout, each leaf laid out on `device` and moved to `out` as
    `jax_leaves` does. Raises KeyError where `leaves` holds a path the
    model has not."""
    groups = _by_path(model, set(jax_paths(model)))
    unknown = sorted(set(leaves) - set(groups))
    if unknown:
        raise KeyError(f"JAX leaves the model has not: {unknown}")
    state: Dict[str, torch.Tensor] = {}
    for path, t in leaves.items():
        by_layer = groups[path]
        stacked = None not in by_layer
        if port_layout(path, t, stacked=stacked) is not t:  # a transpose: on `device`
            t = port_layout(path, t.to(device), stacked=stacked)
        t = t.contiguous().to(out)
        if not stacked:
            state[by_layer[None]] = t
            continue
        if t.shape[0] != len(by_layer):
            raise ValueError(f"{path}: {t.shape[0]} layers, the model has {len(by_layer)}")
        for layer, part in enumerate(t.unbind(0)):
            state[by_layer[layer]] = part
    return state


def _to_torch(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a tree read from disk (`load_jax_params`)
        return x
    x = np.array(x)  # a writable copy: device_get hands out read-only arrays
    if x.dtype.name == "bfloat16":  # ml_dtypes, which torch.from_numpy rejects
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _convert_leaf(path: Tuple[str, ...], x) -> Tuple[str, torch.Tensor]:
    path = tuple(p for p in path if p != "base")
    if isinstance(x, StoredKernel):
        return ".".join(path[:-1] + ("weight",)), x
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


def renamed_state(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX tree's leaves under the port's names and layouts (the renaming
    of `state_dict_from_jax`, for any module that follows the JAX names),
    unchecked."""
    tree = params.get("params", params)
    out: Dict[str, Any] = {}
    for path, x in _flatten(tree):
        if path[-1] == "kernel_in_dim":  # int4 bookkeeping, no model parameter
            continue
        if "layers" in path:  # scan-stacked: leading [L] axis
            i = path.index("layers")
            for layer in range(len(x)):
                key, t = _convert_leaf(path[: i + 1] + (str(layer),) + path[i + 1 :], x[layer])
                out[key] = t
        else:
            key, t = _convert_leaf(path, x)
            out[key] = t
    return out


def state_dict_from_jax(
    params: Mapping[str, Any], config: AssessorConfig, precision: Precision = Precision(),
    parts: Optional[Tuple[str, ...]] = None,
) -> Dict[str, torch.Tensor]:
    """The port's state_dict for `AIGVAssessor(config, precision)`; a
    quantized tree (JAX `quantize_for_serving(w8a8=True | int8=True |
    int4=True)`) needs the precision that call returns. `parts`: the tree
    holds only these top-level subtrees (`vision_model`, ...), each whole."""
    out = renamed_state(params)
    want = expected_shapes(config, precision)
    if parts is not None:
        want = {k: v for k, v in want.items() if k.split(".", 1)[0] in parts}
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
    "language_model": ("wqkv", "wo", "w1", "w2", "w3",  # InternLM2, Llama, Qwen2
                       "qkv_proj", "o_proj", "gate_up_proj", "down_proj"),  # Phi-3
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
    if w8a8 and (int8 or int4):  # JAX's `quantize_for_serving` refuses the pair
        raise ValueError(
            "--w8a8 excludes --int8/--int4 weight streaming: w8a8 quantizes dense layers "
            "for int8 MXU compute, the others stream int8/int4 weights into bf16 compute")
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
    set JAX's `quantize_tree(only_base=True, exclude=("output", "o_proj"))`
    picks over both towers: the ViT's qkv, proj, fc1, fc2 and InternLM2's
    wqkv, wo, w1, w2, w3 (Phi-3's qkv_proj, gate_up_proj, down_proj) in
    every layer. The LM head, Phi-3's o_proj and everything outside the
    towers stay float, and so do the adapters of a config with LoRA: only
    their bases are quantized.

    int8 / int4 quantize what `quantize_tree` / `quantize_tree_int4` pick
    with `scope="language_model"` and their default `min_size` of 4096 on
    any config at least as wide as `LLMConfig.tiny()`: every dense weight
    under `language_model`, the LM head included, the embedding excluded.
    These are the weights the weight-only model holds as `Int8Linear` /
    `Int4Linear`; it has no float form of a decoder projection. Phi-3's
    `lm_head` is one of them, but its model holds it float (as JAX's does):
    it gets the quantized weight dequantized, as `load_weights_` stores a
    quantized kernel in a float layer.

    The weights must be fp32: quantizing bf16-rounded copies adds error, and
    JAX quantizes before it casts."""
    if not (int8 or int4):
        want = expected_shapes(config, Precision(w8a8=True))
    else:
        want = expected_shapes(config, Precision(int4_weights=int4, int8_weights=not int4))
    quantize = (Int4Linear if int4 else W8A8Linear).quantize
    prefixes = [key[: -len("_scale")] for key in want if key.endswith(".weight_scale")]
    out = dict(state_dict)
    for prefix in prefixes:  # "<module>.weight"
        w = out[prefix]
        if w.dtype != torch.float32:
            raise TypeError(f"{prefix} is {w.dtype}: quantize from the fp32 weights")
        out[prefix], out[prefix + "_scale"] = quantize(w)
    head = "language_model.lm_head.weight"  # Phi-3's float head, which JAX quantizes
    if (int8 or int4) and head in out:
        q, scale = quantize(out[head])
        out[head] = (int8_matmul.dequantize_kernel_int4(q, scale, out[head].shape[1]) if int4
                     else int8_matmul.dequantize_kernel(q, scale))
    return out


def load_reference_checkpoint(path: str, config: AssessorConfig) -> Dict[str, torch.Tensor]:
    """fp32 state_dict of `AIGVAssessor(config)` from a reference-format
    checkpoint (a directory or weight files): the JAX converter's name map
    (`tools/convert_weights.convert`: InternLM2's names, HF Phi-3's fused
    `qkv_proj` / `gate_up_proj`, HF Llama / Qwen2's q/k/v fused into `wqkv`),
    then `state_dict_from_jax`. A tied config takes no LM head: an
    `lm_head.weight` that the checkpoint stores beside the embedding it is
    tied to is dropped. Raises FileNotFoundError where there are no
    weights."""
    from aigv_assessor_torch.tools.convert_weights import (
        convert, load_torch_state_dict, resolve_checkpoint_files)

    tree = convert(load_torch_state_dict(resolve_checkpoint_files(path)), config)
    if config.llm.tie_word_embeddings:
        tree["params"].get("language_model", {}).pop("output", None)
    return {k: v.float() for k, v in state_dict_from_jax(tree, config).items()}


def _base_leaves(model: torch.nn.Module):
    """(name, module, leaf, fp32 shape) of every base tensor of `model`, in
    the order of `named_parameters` of the same model built float: module by
    module, a quantized layer's float weight [out, in] first, then each
    module's own parameters; adapter leaves left out."""
    for prefix, m in model.named_modules():
        prefix = f"{prefix}." if prefix else ""
        if isinstance(m, QuantizedLinear):
            yield prefix + "weight", m, "weight", (m.weight.shape[0], m.in_features)
        for leaf, p in m.named_parameters(recurse=False):
            if leaf not in LORA_LEAVES:
                yield prefix + leaf, m, leaf, tuple(p.shape)


def _store_(module: torch.nn.Module, leaf: str, value: torch.Tensor) -> None:
    """Store one fp32 base tensor: quantized into a quantized layer's weight
    and scale, else rounded to the parameter's own dtype."""
    if leaf == "weight" and isinstance(module, QuantizedLinear):
        module.load_float_weight_(value)
    else:
        getattr(module, leaf).copy_(value)


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
    its dtype or precision (`_base_leaves`' order), and stored in the
    model's own form (`_store_`): a model held in bf16 gets, bit for bit,
    the fp32 draw cast to bf16, a quantized one the quantized fp32 draw, and
    neither holds more than one fp32 tensor at a time."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for _, module, leaf, shape in _base_leaves(model):
        _store_(module, leaf, torch.empty(shape, dtype=torch.float32, device=device).normal_(
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


def _uniform(like: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    """uniform(-bound, bound) in fp32 of `like`'s shape and device."""
    return torch.empty(like.shape, dtype=torch.float32, device=like.device).uniform_(
        -bound, bound, generator=gen)


@torch.no_grad()
def init_lora_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw every adapter as the JAX `LoRADense` initialises it: `lora_a`
    uniform with variance (1 / r) / fan_in, drawn in fp32 and stored in its
    own dtype, `lora_b` zeros, so the model computes the base function until
    `lora_b` moves."""
    gen: Optional[torch.Generator] = None
    for m in model.modules():
        if not (isinstance(m, AdaptedLinear) and m.lora is not None):
            continue
        if gen is None:
            gen = torch.Generator(device=m.lora_a.device).manual_seed(seed)
        fan_in, r = m.lora_a.shape
        bound = math.sqrt(3.0 * (1.0 / r) / fan_in)
        m.lora_a.copy_(_uniform(m.lora_a, bound, gen))
        m.lora_b.zero_()
    return model


@torch.no_grad()
def init_score_head_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw the score head as the JAX `ScoreMLP` initialises it: weights
    uniform in (-0.1, 0.1), drawn in fp32 and stored in their own dtype,
    biases zero."""
    for m in model.modules():
        if isinstance(m, ScoreMLP):
            gen = torch.Generator(device=m.fc1.weight.device).manual_seed(seed)
            for i in range(m.num_layers):
                fc = getattr(m, f"fc{i + 1}")
                fc.weight.copy_(_uniform(fc.weight, 0.1, gen))
                fc.bias.zero_()
    return model


def _holds(module: torch.nn.Module, kernel: StoredKernel) -> bool:
    """True where `module` keeps `kernel`'s bits as they are stored: int8
    in an `Int8Linear`, int4 in an `Int4Linear` (JAX's `--int8` / `--int4`
    over a tree that already holds them)."""
    if kernel.bits == 4:
        return isinstance(module, Int4Linear)
    return type(module) is Int8Linear


@torch.no_grad()
def load_weights_(model: torch.nn.Module, weights: Mapping[str, torch.Tensor],
                  seed: int, *, partial: bool = False) -> torch.nn.Module:
    """Copy `weights` (a float state_dict of `AIGVAssessor(config)`, e.g.
    `load_reference_checkpoint`'s or `weights_from_jax`'s) into `model` in
    place: each base tensor in `_base_leaves`' order, rounded to its
    parameter's dtype or quantized into its layer's int8 weight (`_store_`),
    the rest as `load_state_dict` copies it. A `StoredKernel` goes into a
    layer that holds its kind bit for bit, and into any other layer
    dequantized to fp32 first (JAX's `quantize_for_serving` rules). What
    `weights` lacks may only be the score head, then drawn by
    `init_score_head_(seed + 1)`, and the LoRA adapters, then drawn by
    `init_lora_(seed + 2)` with `lora_b` zero; any other missing or
    unexpected key raises KeyError. `partial`: `weights` replaces only what
    it holds (a graft over a built model) and nothing is drawn."""
    device = next(model.parameters()).device
    stored = set()
    for name, module, leaf, _ in _base_leaves(model):
        if name not in weights:
            continue
        value = weights[name]
        if isinstance(value, StoredKernel):
            if _holds(module, value):
                module.weight.copy_(value.weight())
                module.weight_scale.copy_(value.scale)
            else:
                _store_(module, leaf, value.dequantize(device))
        else:
            _store_(module, leaf, value.to(device))
        stored.add(name)
        if isinstance(module, QuantizedLinear) and leaf == "weight":
            stored.add(name + "_scale")
    rest = {k: v for k, v in weights.items() if k not in stored}
    missing, unexpected = model.load_state_dict(rest, strict=False)
    missing = [] if partial else [k for k in missing if k not in stored]
    drawn = [k for k in missing if not (is_lora_param(k) or k.startswith("mlpscore."))]
    if unexpected or drawn:
        raise KeyError(f"weights do not match the model: missing {drawn}, "
                       f"unexpected {unexpected}")
    if any(k.startswith("mlpscore.") for k in missing):
        init_score_head_(model, seed + 1)
    if any(is_lora_param(k) for k in missing):
        init_lora_(model, seed + 2)
    return model


def shard_for_inference(model: torch.nn.Module, mesh=None, mesh_config=None):
    """`model` wrapped by `parallel/sharding.shard_params` over `mesh`, or
    one `core/mesh.make_mesh` builds from `mesh_config` (default
    `MeshConfig.auto(fsdp=True)`) -> (mesh, model). Needs a process group."""
    from aigv_assessor_torch.core.mesh import MeshConfig, make_mesh
    from aigv_assessor_torch.parallel.sharding import shard_params

    mesh = mesh or make_mesh(mesh_config or MeshConfig.auto(fsdp=True))
    return mesh, shard_params(model.eval(), mesh)
