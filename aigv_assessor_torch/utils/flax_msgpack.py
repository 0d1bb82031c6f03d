"""flax's msgpack format (`flax.serialization.msgpack_serialize` /
`msgpack_restore`), read and written without flax: the container of the JAX
package's `params.msgpack`, `lora_weights.msgpack` and its tools' outputs.

The format:

- the tree is msgpack maps (string keys), lists and Python scalars, with
  two extension types at the leaves: 1, an array, packed as
  `msgpack.packb((shape, dtype name, C-order bytes))`, and 3, a numpy
  scalar, packed the same way as a 0-d array;
- a leaf above `MAX_CHUNK_SIZE` (2**30) bytes is stored as
  `{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
  {"0": flat chunk, ...}}`, each chunk `MAX_CHUNK_SIZE // itemsize` values
  of the flattened array (InternVL2-26B's fp32 embedding, 2.27 GB, arrives
  as three);
- flax's `msgpack_serialize` writes every map with its keys sorted, as
  `jax.tree_util` rebuilds a dict (`to_bytes` serializes in place: a dict's
  own order); the chunk record keeps the order above.

Arrays come back as torch tensors, whatever their dtype, `bfloat16`
included (numpy has no such dtype without `ml_dtypes`): one representation
for the whole tree. A numpy scalar (extension 3) comes back as a numpy
scalar, or as a 0-d tensor where its dtype is `bfloat16`. The writer takes
torch tensors, numpy arrays and numpy scalars, and its bytes equal flax's
for the same tree.

The `msgpack` package is imported when a file is read or written. Where it
is missing, both raise ImportError: convert the file where `msgpack` is
installed (`tools/convert_to_int8.py` or `models/loading.save_jax_params`
write the same tree as safetensors).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _msgpack(what: str):
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"{what}: flax's msgpack format needs the `msgpack` package, which is not "
            "installed here; convert the file to safetensors where it is "
            "(models/loading.save_jax_params)") from e
    return msgpack


# ------------------------------------------------------------------- read --


def _array_from_bytes(msgpack, data: bytes) -> torch.Tensor:
    shape, name, buffer = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name not in _TORCH_DTYPES:
        raise ValueError(f"array of dtype {name!r}: not a dtype the port reads")
    shape = tuple(shape)
    if not buffer:
        return torch.empty(shape, dtype=_TORCH_DTYPES[name])
    # a writable copy of this leaf's bytes alone: the tensor owns its memory
    flat = torch.frombuffer(bytearray(buffer), dtype=_TORCH_DTYPES[name])
    return flat.reshape(shape)


def _unchunk(record: dict) -> torch.Tensor:
    shape = tuple(record["shape"][str(i)] for i in range(len(record["shape"])))
    chunks = [record["chunks"][str(i)] for i in range(len(record["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def restore(encoded: bytes) -> Any:
    """The tree of flax's `msgpack_restore(encoded)`, arrays as tensors."""
    msgpack = _msgpack("restoring a flax msgpack tree")

    def ext_hook(code: int, data: bytes):
        if code == EXT_NDARRAY:
            return _array_from_bytes(msgpack, data)
        if code == EXT_NPSCALAR:
            t = _array_from_bytes(msgpack, data)
            return t if t.dtype == torch.bfloat16 else t.numpy()[()]
        raise ValueError(f"msgpack extension type {code}: not one flax writes for a tree")

    return _unchunk_tree(msgpack.unpackb(encoded, ext_hook=ext_hook, raw=False))


def load(path: str) -> Any:
    """`restore` of a file's bytes."""
    _msgpack(path)
    with open(path, "rb") as f:
        return restore(f.read())


# ------------------------------------------------------------------ write --


def _array_bytes(msgpack, x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype not in _DTYPE_NAMES:
            raise ValueError(f"tensor of dtype {x.dtype}: flax has no name for it")
        name = _DTYPE_NAMES[x.dtype]
        raw = x.view(torch.int16).numpy().tobytes() if name == "bfloat16" else x.numpy().tobytes()
        shape = tuple(x.shape)
    else:
        x = np.asarray(x)
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes have no flax form")
        name, raw, shape = x.dtype.name, x.tobytes("C"), x.shape
    return msgpack.packb((shape, name, raw), use_bin_type=True)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _prepare(tree: Any, sort_keys: bool = True) -> Any:
    """flax's copy of the tree: maps rebuilt with sorted keys (or in their
    order), then large arrays chunked."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k], sort_keys) for k in (sorted(tree) if sort_keys else tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(v, sort_keys) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def serialize(tree: Any, sort_keys: bool = True) -> bytes:
    """The bytes of flax's `msgpack_serialize(tree)`; with `sort_keys`
    false, of `to_bytes(tree)`, which serializes a tree of dicts in place,
    its maps in their insertion order."""
    msgpack = _msgpack("serializing a flax msgpack tree")

    def default(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return msgpack.ExtType(EXT_NDARRAY, _array_bytes(msgpack, x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(EXT_NPSCALAR, _array_bytes(msgpack, np.asarray(x)))
        raise TypeError(f"{type(x).__name__} has no flax msgpack form")

    return msgpack.packb(_prepare(tree, sort_keys), default=default, strict_types=True)


def save(path: str, tree: Any, sort_keys: bool = True) -> None:
    """`serialize(tree, sort_keys)` into a file."""
    _msgpack(path)
    data = serialize(tree, sort_keys)
    with open(path, "wb") as f:
        f.write(data)
