"""Parameter and batch sharding (`aigv_assessor_tpu/parallel/sharding.py`)
with FSDP2 (`torch.distributed.fsdp.fully_shard`) over the mesh of
`core/mesh.py`.

`param_spec` is JAX's rule table carried over to the port's parameter names
and layouts: the name is turned into the JAX tree's path
(`language_model.layers.3.attention.wqkv.weight` ->
`language_model/layers/attention/wqkv/base/kernel`, stacked over layers),
JAX's rules and its divisibility guard give the spec in JAX's layout, and
the spec is carried onto the port's dims: a dense kernel [in, out] is a
weight [out, in] here, a conv kernel [*k, in, out] a weight [out, in, *k];
embeddings and adapters keep JAX's layout. JAX's table names no Phi-3
projection (`qkv_proj`, `o_proj`, `gate_up_proj`, `down_proj`, `lm_head`,
`embed_tokens`), so those take its default rule, the largest divisible dim,
as they do in JAX. It takes the axis sizes, not a live mesh.

`tensor_plan` carries JAX's `tensor` axis onto the port: a tower projection
is split where JAX's spec puts `tensor` on its kernel and the tower's heads
divide, everything else is replicated over the axis (see its docstring).
`shard_params` first cuts those towers to this rank's heads
(`split_towers_`, `parallel/tensor.py`), then wraps each ViT layer and each
decoder layer, then the root, in `fully_shard` over the (data, fsdp)
sub-mesh of the ranks that share this rank's `tensor` coordinate: HSDP,
replicated over `data` and sharded over `fsdp`. Each parameter is sharded on the dim `param_spec`
gives `fsdp`; where JAX replicates it, FSDP2 shards dim 0 (same result,
less memory). The root unit holds the embeddings, the final norm, the LM
head (tied embeddings too), the projectors, SlowFast and the score head, so
the root's methods that read them outside `forward` (`score_perspectives`,
`embed_multimodal`, `embed_tokens`, `extract_feature`, `extract_motion`,
`score`, `prefill`, `decode_step`) are registered as FSDP forward methods;
no registered method calls another or `forward`. Buffers (the W8A8 / int8 /
int4 weights, SlowFast's statistics) are not parameters: FSDP2 leaves them
whole on every rank, where JAX shards them.

`shard_batch` keeps per-process semantics: each rank's loader holds its own
rows (JAX's `process_local`; the ranks of a tensor group the same rows), so
it moves them to the device and checks that the global rows divide over
data x fsdp. Where they do not, JAX replicates the batch: every rank then
holds and runs the whole batch.
"""

from __future__ import annotations

import inspect
import logging
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from aigv_assessor_torch.core.dist import process_count
from aigv_assessor_torch.core.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    TENSOR_AXIS,
    MeshConfig,
    mesh_config_of,
    tensor_coords,
    tensor_group,
)
from aigv_assessor_torch.parallel.tensor import COLUMN, TensorSplit, split_leaves
from aigv_assessor_torch.models.loading import _TOWER_PROJECTIONS

logger = logging.getLogger(__name__)

Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

_COLUMN = (FSDP_AXIS, TENSOR_AXIS)  # [in, out]: out split over TP
_ROW = (TENSOR_AXIS, FSDP_AXIS)  # [in, out]: in split over TP

# JAX's table (path regex, spec in the JAX layout), first match wins
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # ---- InternLM2 ----
    (r"wqkv/.*kernel$", _COLUMN),
    (r"wo/.*kernel$", _ROW),
    (r"feed_forward/w1/.*kernel$", _COLUMN),
    (r"feed_forward/w3/.*kernel$", _COLUMN),
    (r"feed_forward/w2/.*kernel$", _ROW),
    (r"tok_embeddings/embedding$", (None, FSDP_AXIS)),
    (r"output/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    # ---- ViT ----
    (r"attn/qkv/.*kernel$", _COLUMN),
    (r"attn/proj/.*kernel$", _ROW),
    (r"mlp/fc1/.*kernel$", _COLUMN),
    (r"mlp/fc2/.*kernel$", _ROW),
    (r"patch_embedding/kernel$", (None, None, None, FSDP_AXIS)),
    (r"position_embedding$", (None, None, FSDP_AXIS)),
    # ---- projectors / heads ----
    (r"mlp1/.*kernel$", (FSDP_AXIS, None)),
    (r"motion_mlp/.*kernel$", (FSDP_AXIS, None)),
    (r"mlpscore/.*kernel$", (FSDP_AXIS, None)),
    # ---- LoRA adapters ----
    (r"lora_a$", (FSDP_AXIS, None)),
    (r"lora_b$", (None, FSDP_AXIS)),
    # ---- motion conv kernels: output channels ----
    (r"slowfast_model/.*conv/kernel$", (None, None, None, None, FSDP_AXIS)),
)

_EMBEDDINGS = ("tok_embeddings", "embed_tokens")
_FORWARD_METHODS = ("score_perspectives", "embed_multimodal", "embed_tokens",
                    "extract_feature", "extract_motion", "score", "prefill", "decode_step")


def _sizes(mesh_shape) -> Dict[str, int]:
    if isinstance(mesh_shape, MeshConfig):
        return mesh_shape.shape
    if hasattr(mesh_shape, "mesh_dim_names"):  # a DeviceMesh
        return mesh_config_of(mesh_shape).shape
    return {a: int(mesh_shape.get(a, 1)) for a in (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)}


def jax_path(name: str, ndim: int) -> Tuple[str, bool, Tuple[int, ...]]:
    """(the JAX tree's path of a port parameter, whether JAX stacks it over
    layers, the port dim of each JAX dim)."""
    parts = name.split(".")
    stacked = False
    path = []
    for i, p in enumerate(parts[:-1]):
        if i and parts[i - 1] == "layers" and p.isdigit():
            stacked = True
        else:
            path.append(p)
    leaf = parts[-1]
    to_jax = tuple(range(ndim))
    if leaf == "weight" and ndim >= 2:
        if path and path[-1] in _EMBEDDINGS:
            leaf = "embedding"
        else:
            leaf = "kernel"
            # a dense [out, in] -> [in, out]; a conv [out, in, *k] -> [*k, in, out]
            to_jax = tuple(range(2, ndim)) + (1, 0)
    if stacked and path and path[-1] in _TOWER_PROJECTIONS.get(path[0], ()) and leaf not in (
            "lora_a", "lora_b"):
        path.append("base")
    return "/".join(path + [leaf]), stacked, to_jax


def _guard(spec: Spec, shape: Tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
    """Drop axes whose dim is not divisible by the axis size (JAX's
    `_guard`)."""
    if len(spec) > len(shape):
        return (None,) * len(shape)
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        size = 1
        for a in axis if isinstance(axis, tuple) else (axis,):
            size *= sizes[a]
        out.append(axis if size > 1 and dim % size == 0 else None)
    return tuple(out)


def jax_spec(path: str, shape: Tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
    """JAX's `param_spec` on a JAX path and shape, padded to the rank."""
    stacked = re.search(r"/layers/", path) is not None
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            if stacked:
                spec = (None,) + tuple(spec)
            return _guard(spec, shape, sizes)
    first = 1 if stacked else 0
    if len(shape) - first >= 2:
        fsdp = sizes.get(FSDP_AXIS, 1)
        if fsdp > 1:
            order = sorted(range(first, len(shape)), key=lambda i: -shape[i])
            for dim in order:
                if shape[dim] % fsdp == 0 and shape[dim] >= fsdp:
                    spec = [None] * len(shape)
                    spec[dim] = FSDP_AXIS
                    return tuple(spec)
    return (None,) * len(shape)


def param_spec(name: str, shape: Tuple[int, ...], mesh_shape) -> Spec:
    """The mesh axis (or None) of each dim of the port's parameter `name` of
    `shape`, by JAX's rules; `mesh_shape` is a `MeshConfig`, a DeviceMesh or
    {axis: size}."""
    sizes = _sizes(mesh_shape)
    shape = tuple(shape)
    path, stacked, to_jax = jax_path(name, len(shape))
    jshape = tuple(shape[d] for d in to_jax)
    if stacked:
        # JAX's leaf has a leading [num_layers] dim, which no rule shards;
        # its size does not enter the rules either
        jshape = (1,) + jshape
    spec = jax_spec(path, jshape, sizes)[1 if stacked else 0:]
    out = [None] * len(shape)
    for j, d in enumerate(to_jax):
        out[d] = spec[j]
    return tuple(out)


def fsdp_dim(name: str, shape: Tuple[int, ...], mesh_shape) -> Optional[int]:
    """The port dim that `param_spec` shards over `fsdp`, or None."""
    for d, axis in enumerate(param_spec(name, shape, mesh_shape)):
        if axis == FSDP_AXIS or (isinstance(axis, tuple) and FSDP_AXIS in axis):
            return d
    return None


# ------------------------------------------------------------------ FSDP2 --


def is_sharded(model: nn.Module) -> bool:
    """True for a model `shard_params` wrapped."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def dp_mesh(mesh):
    """The (data, fsdp) sub-mesh FSDP2 runs over: the ranks that share this
    rank's `tensor` coordinate."""
    return mesh[DATA_AXIS, FSDP_AXIS]


# ----------------------------------------------------------------- tensor --

REPLICATED = "replicated"


def _tensor_units(model: nn.Module):
    """(module name, module, {projection: role}) of every module that may
    split over `tensor` (the ones whose class lists `TENSOR_ROLES`)."""
    for name, m in model.named_modules():
        roles = getattr(type(m), "TENSOR_ROLES", None)
        if roles:
            yield name, m, roles


def tensor_plan(model: nn.Module, mesh_shape) -> Dict[str, str]:
    """{projection module name: 'column' | 'row' | 'replicated'} over the
    `tensor` axis, for every projection of the towers' attention and MLP
    modules. A projection is split exactly where JAX's `param_spec` puts
    `tensor` on its kernel (the output dim of a column-parallel one, the
    input dim of a row-parallel one), and only where its whole tower can:
    every projection of the tower float (a quantized base's `kernel_int8` /
    `kernel_int4` matches no `kernel$` rule), split by JAX, and the heads
    dividing by the axis size (the kernels need whole heads per rank: the
    ViT's heads, the decoder's kv heads). Phi-3's modules list no roles
    (JAX's table names none of its projections). Everything else is
    replicated over `tensor`, also where JAX puts the axis on it: the LM
    head where the vocabulary divides, and `motion_mlp`'s fc1 / fc2, which
    the ViT's `mlp/fc1`, `mlp/fc2` patterns match (the result is the same;
    the port's scores, logits and tokens are then the same bits on every
    rank of a tensor group)."""
    from aigv_assessor_torch.models.lora import LoRALinear

    sizes = _sizes(mesh_shape)
    size = sizes[TENSOR_AXIS]
    units = list(_tensor_units(model))
    splits: Dict[str, bool] = {}
    for name, m, roles in units:
        tower = name.split(".")[0]
        ok = size > 1 and m.tensor_divides(size)
        for child, role in roles.items():
            lin = getattr(m, child)
            ok = ok and type(lin) in (nn.Linear, LoRALinear)
            if ok:
                spec = param_spec(f"{name}.{child}.weight", tuple(lin.weight.shape), sizes)
                axis = spec[0 if role == COLUMN else 1]
                ok = axis == TENSOR_AXIS or (isinstance(axis, tuple) and TENSOR_AXIS in axis)
        splits[tower] = splits.get(tower, True) and ok
    return {f"{name}.{child}": role if splits[name.split(".")[0]] else REPLICATED
            for name, m, roles in units for child, role in roles.items()}


def split_towers_(model: nn.Module, split: TensorSplit) -> Dict[str, str]:
    """Cut the towers `tensor_plan` splits over `split.size` ranks to rank
    `split.rank`'s heads, in place (`parallel/tensor.py`; `split.group`
    None builds the group-less form) -> the plan. A tower that stays whole
    is logged."""
    plan = tensor_plan(model, {TENSOR_AXIS: split.size})
    towers: Dict[str, bool] = {}
    for name, m, roles in list(_tensor_units(model)):
        cut = plan[f"{name}.{next(iter(roles))}"] != REPLICATED
        if cut:
            m.split_(split)
        towers[name.split(".")[0]] = cut
    for tower, cut in towers.items():
        logger.log(logging.INFO if cut else logging.WARNING, "%s: %s over tensor %d", tower,
                   "split by heads" if cut else "replicated (its heads do not divide, JAX's "
                   "rules do not split it, or its projections are quantized)", split.size)
    return plan


def fsdp_group(mesh):
    """The process group of the `fsdp` axis: the ranks that hold one
    parameter's shards."""
    return mesh.get_group(FSDP_AXIS)


def _layer_units(model: nn.Module):
    """Each layer of every `layers` list (the ViT's and the decoder's)."""
    for name, module in model.named_modules():
        if name.split(".")[-1] == "layers" and isinstance(module, nn.ModuleList):
            yield from module


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Cut the towers over `mesh`'s `tensor` axis (`split_towers_`), then
    wrap `model` in FSDP2 over its (data, fsdp) axes, in place: each layer,
    then the root. Parameters keep their names; they become DTensors
    sharded on `param_spec`'s fsdp dim, which is taken from the unsplit
    shape, as JAX's guard takes it, and applied to this rank's shard.
    -> the model."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    rank, size = tensor_coords(mesh)
    if size > 1:
        split_towers_(model, TensorSplit(size, rank, tensor_group(mesh)))
    sub = dp_mesh(mesh)
    sizes = mesh_config_of(mesh).shape
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = split_leaves(model)

    def placement(p: nn.Parameter):
        name = names[id(p)]
        shape = list(p.shape)
        if name in leaves:
            shape[leaves[name].dim] *= sizes[TENSOR_AXIS]
        d = fsdp_dim(name, tuple(shape), sizes)
        return Shard(d) if d is not None else None  # None: FSDP2's Shard(0)

    kw: Dict[str, Any] = {"mesh": sub}
    if "shard_placement_fn" in inspect.signature(fully_shard).parameters:
        kw["shard_placement_fn"] = placement
    else:
        logger.warning("this torch's fully_shard takes no shard_placement_fn: every "
                       "parameter is sharded on dim 0")
    for layer in _layer_units(model):
        fully_shard(layer, **kw)
    fully_shard(model, **kw)
    for method in _FORWARD_METHODS:
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    return model


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a (possibly sharded) parameter; a collective on
    every rank for a DTensor."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view), or the tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def shard_batch(batch: Mapping[str, Any], mesh, *, batch_dim: int = 0,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """This rank's rows of every tensor leaf on `device` (the mesh's by
    default). Each rank holds its own rows of the global batch, the same as
    the other ranks of its tensor group. A leaf whose global rows (local x
    world / tensor) do not divide over data x fsdp is replicated, as JAX
    replicates it: every rank must then hold, and runs, the whole batch
    (logged)."""
    sizes = _sizes(mesh)
    n = sizes[DATA_AXIS] * sizes[FSDP_AXIS]
    procs = process_count() // sizes[TENSOR_AXIS]
    if device is None:
        device = torch.device(mesh.device_type) if hasattr(mesh, "device_type") else None
        if device is not None and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) or hasattr(v, "__array__"):
            v = torch.as_tensor(v)
            if v.ndim > batch_dim:
                rows = v.shape[batch_dim] * procs
                if procs > 1 and (rows % n or rows < n):
                    logger.warning("%s: %d global rows do not split over %d ranks: every "
                                   "rank runs the whole batch", k, rows, n)
            out[k] = v.to(device) if device is not None else v
        else:
            out[k] = v
    return out
