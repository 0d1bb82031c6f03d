"""Weights: the JAX parameter tree mapped onto the port's `state_dict`, and
seeded random weights made on the device.

`state_dict_from_jax` takes the JAX package's parameter tree with numpy
leaves (what `jax.device_get(model.init(...))` returns) and gives the
`state_dict` of the port's `AIGVAssessor` for the same config:

- `layers` stacked by scan-over-layers (leading [L] axis) become one entry
  per layer of a `ModuleList` (`layers.0`, `layers.1`, ...);
- the `base` level of the JAX LoRA wrappers is dropped;
- flax `Dense` kernels [in, out] become `nn.Linear` weights [out, in];
  head-major projections keep the JAX head order, which is the order of the
  Linear's output features;
- conv kernels HWIO / DHWIO become OIHW / OIDHW;
- `embedding` and the flax LayerNorm's `scale` become `weight`;
- a W8A8 tree's `kernel_int8` [in, out] becomes the int8 `weight` [out, in]
  of a `W8A8Linear`, and its fp32 `kernel_scale` becomes `weight_scale`.

Any key left over or missing, or any shape that differs, raises.

`quantize_for_serving` makes the W8A8 weights from float ones, as the JAX
`quantize_for_serving(w8a8=True)` does.

Reading a checkpoint from disk (`params.msgpack` needs flax, the reference
safetensors need `safetensors`) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.motion import FrozenBatchNorm
from aigv_assessor_torch.models.vit import InternVisionEncoderLayer
from aigv_assessor_torch.ops.norms import LayerNorm, RMSNorm
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
    if name == "kernel_scale":
        name = "weight_scale"
    elif name in ("kernel", "kernel_int8"):
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
    """The port's state_dict for `AIGVAssessor(config, precision)`; a W8A8
    tree (JAX `quantize_for_serving(w8a8=True)`) needs `precision.w8a8`."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, x in _flatten(tree):
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


@torch.no_grad()
def quantize_for_serving(
    state_dict: Mapping[str, torch.Tensor], config: AssessorConfig
) -> Dict[str, torch.Tensor]:
    """W8A8 serving weights from the fp32 state_dict of `AIGVAssessor(config)`:
    the state_dict of the same model under `Precision(w8a8=True)`.

    The weights quantized are those the W8A8 model holds as `W8A8Linear`s,
    the set JAX's `quantize_tree(only_base=True)` picks over both towers: the
    ViT's qkv, proj, fc1, fc2 and InternLM2's wqkv, wo, w1, w2, w3 in every
    layer. The LM head and everything outside the towers stay float. The
    weights must be fp32: quantizing bf16-rounded copies adds error, and
    JAX quantizes before it casts."""
    want = expected_shapes(config, Precision(w8a8=True))
    out = dict(state_dict)
    for key in want:
        if not key.endswith(".weight_scale"):
            continue
        prefix = key[: -len("_scale")]  # "<module>.weight"
        w = out[prefix]
        if w.dtype != torch.float32:
            raise TypeError(f"{prefix} is {w.dtype}: quantize from the fp32 weights")
        out[prefix], out[key] = quantize_kernel(w)
    return out


@torch.no_grad()
def init_random_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every weight in place from a seeded generator on the model's
    device: normal(0, INIT_STD) for weights and biases, norms at weight 1 and
    bias 0, frozen batch norm at the identity, LayerScale at the vision
    config's `initializer_factor`. Random rather than zero, so that attention
    is not uniform and a masking fault shows."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for p in model.parameters():
        p.normal_(0.0, INIT_STD, generator=gen)
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
