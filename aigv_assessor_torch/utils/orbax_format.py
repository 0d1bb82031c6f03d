"""A pytree of arrays in the layout orbax's `StandardCheckpointHandler`
writes (`PyTreeCheckpointHandler` over OCDBT, zarr v2), read and written
without orbax, tensorstore or JAX.

One item directory (`<dir>/<step>/default/` of a `CheckpointManager`, or
what `StandardCheckpointer.save(path, ...)` fills) holds:

- `_METADATA`: JSON, `{"tree_metadata": {str(key tuple): {"key_metadata":
  [{"key", "key_type": 2 for a dict key or a named field, 1 for a sequence
  index}, ...], "value_metadata": {"value_type": "jax.Array" | "None",
  "skip_deserialize", "write_shape"}}}, "use_ocdbt": true, "use_zarr3":
  false, "store_array_data_equal_to_fill_value": true, "custom_metadata":
  null}`, the leaves in the order `jax.tree_util` flattens the tree. An
  empty node (optax's `EmptyState`) is a "None" leaf that restore skips.
- `_sharding`: JSON `{base64(leaf name): JSON of the sharding}`, the leaf
  name being the key tuple joined by '.'.
- `array_metadatas/process_0`: JSON `{"array_metadatas": [{"array_metadata":
  {"param_name", "write_shape", "chunk_shape", "ext_metadata": null}}]}`.
- The OCDBT store (`utils/ocdbt.py`) holding, per array, `<name>/.zarray`
  (zarr v2 metadata, compact JSON with sorted keys, e.g.
  `{"chunks":[3,4],"compressor":{"id":"zstd","level":1},
  "dimension_separator":".","dtype":"bfloat16","fill_value":null,
  "filters":null,"order":"C","shape":[3,4],"zarr_format":2}`) and each chunk
  under `<name>/<chunk index joined by '.'>` (`0` for a scalar): the chunk's
  C-order bytes, padded to the full chunk shape at the array's edges, as
  one zstd frame.

Orbax writes an unsharded array as one chunk unless it is larger than its
OCDBT target data file size, 2 GiB; then `choose_chunk_shape` below (a copy
of orbax's `arrays/subchunking.choose_chunk_shape` for an unsharded write)
cuts the largest dimension to its next smaller divisor until a chunk fits.
"""

from __future__ import annotations

import base64
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aigv_assessor_torch.utils import ocdbt, zstd

KEY_DICT, KEY_SEQUENCE = 2, 1
TARGET_CHUNK_BYTES = 2**31  # orbax's default OCDBT target data file size
CHUNK_ZSTD_LEVEL = 1

# zarr v2 dtype strings (little-endian) <-> torch
_DTYPES = {
    "<f4": torch.float32, "<f8": torch.float64, "<f2": torch.float16, "bfloat16": torch.bfloat16,
    "<i4": torch.int32, "<i8": torch.int64, "<i2": torch.int16, "|i1": torch.int8,
    "|u1": torch.uint8, "<u4": torch.uint32, "|b1": torch.bool,
}
_ZARR_DTYPE = {v: k for k, v in _DTYPES.items()}

# the sharding orbax records for a leaf of a one-device (data, fsdp, tensor) mesh
_ONE_DEVICE_SHARDING = json.dumps({
    "sharding_type": "NamedSharding", "shape": [1, 1, 1],
    "axis_names": ["data", "fsdp", "tensor"],
    "axis_types": ["AxisType.Auto", "AxisType.Auto", "AxisType.Auto"],
    "partition_spec": [], "device_mesh": {"mesh": [[[{"id": 0}]]]}})

Key = Tuple[Tuple[str, int], ...]  # ((key, key_type), ...)


def leaf_name(key: Key) -> str:
    return ".".join(k for k, _ in key)


def _threads() -> int:
    return min(16, os.cpu_count() or 4)


def choose_chunk_shape(shape: Sequence[int], itemsize: int,
                       target_bytes: int) -> Tuple[int, ...]:
    """The chunk shape orbax picks for an unsharded array: the whole shape
    when it fits `target_bytes`, else the largest dimension cut to its next
    smaller divisor, repeatedly, until a chunk fits."""
    shape = tuple(max(1, int(d)) for d in shape)
    if math.prod(shape) * itemsize <= target_bytes:
        return shape
    divisors = [[d for d in range(1, n + 1) if n % d == 0] for n in shape]
    target = target_bytes // itemsize
    while math.prod(f[-1] for f in divisors) > target:
        dim = max(range(len(shape)), key=lambda i: (divisors[i][-1], -i))
        divisors[dim].pop()
    return tuple(f[-1] for f in divisors)


def _chunk_indices(shape: Sequence[int], chunks: Sequence[int]) -> Iterator[Tuple[int, ...]]:
    grid = [max(1, -(-s // c)) for s, c in zip(shape, chunks)]
    yield from np.ndindex(*grid) if grid else iter([()])


def _chunk_key(name: str, index: Tuple[int, ...]) -> str:
    return f"{name}/{'.'.join(map(str, index)) if index else '0'}"


def _as_bytes(t: torch.Tensor) -> np.ndarray:
    """The C-order bytes of a CPU tensor as a uint8 array (a view of its
    storage where it is contiguous)."""
    t = t.detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.empty(0, np.uint8)


def _chunk_bytes(t: torch.Tensor, index: Tuple[int, ...], chunks: Tuple[int, ...]) -> np.ndarray:
    """One chunk of `t`, padded with zeros to the full chunk shape."""
    if not chunks:
        return _as_bytes(t)
    sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(index, chunks))
    part = t[sl]
    if tuple(part.shape) != chunks:
        full = torch.zeros(chunks, dtype=t.dtype)
        full[tuple(slice(0, s) for s in part.shape)] = part
        part = full
    return _as_bytes(part)


# --------------------------------------------------------------- writing --

def write_tree(directory: str, leaves: Sequence[Tuple[Key, Optional[torch.Tensor]]]) -> None:
    """Write `leaves` ((key, tensor on the CPU or None for an empty node),
    in the order `jax.tree_util` flattens the tree) as one orbax item at
    `directory`, which must not exist yet or be empty. An array above
    `TARGET_CHUNK_BYTES` is cut into chunks as orbax cuts it."""
    os.makedirs(directory, exist_ok=True)
    if os.listdir(directory):
        raise FileExistsError(f"{directory} is not empty")
    tree_metadata, shardings, array_metadata = {}, {}, []
    jobs: List[Tuple[str, torch.Tensor, Tuple[int, ...], Tuple[int, ...]]] = []
    zarrays = {}
    for key, t in leaves:
        name = leaf_name(key)
        value = {"value_type": "None", "skip_deserialize": True}
        if t is not None:
            if t.dtype not in _ZARR_DTYPE:
                raise TypeError(f"{name}: dtype {t.dtype} has no zarr v2 name here")
            shape = tuple(t.shape)
            chunks = choose_chunk_shape(shape, t.element_size(), TARGET_CHUNK_BYTES)
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(shape)}
            zarrays[name] = json.dumps({
                "chunks": list(chunks), "compressor": {"id": "zstd", "level": CHUNK_ZSTD_LEVEL},
                "dimension_separator": ".", "dtype": _ZARR_DTYPE[t.dtype], "fill_value": None,
                "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2,
            }, sort_keys=True, separators=(",", ":")).encode()
            shardings[base64.b64encode(name.encode()).decode()] = _ONE_DEVICE_SHARDING
            array_metadata.append({"array_metadata": {
                "param_name": name, "write_shape": list(shape), "chunk_shape": list(chunks),
                "ext_metadata": None}})
            for index in _chunk_indices(shape, chunks):
                jobs.append((name, t, index, chunks if shape else ()))
        tree_metadata[str(tuple(k for k, _ in key))] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in key],
            "value_metadata": value,
        }

    def encode(job):
        name, t, index, chunks = job
        return _chunk_key(name, index), zstd.compress(_chunk_bytes(t, index, chunks),
                                                      CHUNK_ZSTD_LEVEL)

    with ocdbt.Writer(directory) as store:
        for name, zarray in zarrays.items():
            store.put(f"{name}/.zarray", zarray)
        with ThreadPoolExecutor(_threads()) as pool:  # libzstd runs without the GIL
            for key, frame in _ordered_map(pool, encode, jobs, 2 * _threads()):
                store.put(key, frame)
    _write_json(os.path.join(directory, "_METADATA"), {
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(directory, "_sharding"), shardings, separators=(",", ":"))
    os.makedirs(os.path.join(directory, "array_metadatas"), exist_ok=True)
    _write_json(os.path.join(directory, "array_metadatas", "process_0"),
                {"array_metadatas": array_metadata})


def _ordered_map(pool: ThreadPoolExecutor, fn, items: Sequence, window: int):
    """`fn` over `items` on the pool, results in order, at most `window`
    pending (so at most that many encoded chunks are held at once)."""
    pending = []
    for item in items:
        pending.append(pool.submit(fn, item))
        if len(pending) >= window:
            yield pending.pop(0).result()
    for f in pending:
        yield f.result()


def _write_json(path: str, obj, **kw) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, **kw)


# --------------------------------------------------------------- reading --

def read_metadata(directory: str) -> Dict[str, dict]:
    """`_METADATA`'s tree, {str(key tuple): entry}, in the tree's order."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ocdbt.OcdbtFormatError(
            f"{directory}: only OCDBT with zarr v2 is read here (use_ocdbt="
            f"{meta.get('use_ocdbt')}, use_zarr3={meta.get('use_zarr3')})")
    return meta["tree_metadata"]


def read_tree(directory: str, names: Optional[Sequence[str]] = None
              ) -> List[Tuple[Key, Optional[torch.Tensor]]]:
    """Every leaf of the item at `directory` (or those of the leaf `names`),
    (key, tensor or None for a skipped node), in the tree's order."""
    store = ocdbt.Store(directory)
    values = dict(store.items())
    out = []
    jobs = []
    for entry in read_metadata(directory).values():
        key = tuple((k["key"], k["key_type"]) for k in entry["key_metadata"])
        if names is not None and leaf_name(key) not in names:
            continue
        meta = entry["value_metadata"]
        if meta.get("skip_deserialize") or meta["value_type"] == "None":
            out.append((key, None))
            continue
        name = leaf_name(key)
        zkey = f"{name}/.zarray"
        if zkey not in values:
            raise KeyError(f"{directory}: no array {name} in the store")
        zarray = json.loads(store.read(values[zkey]))
        t = _empty_array(name, zarray)
        out.append((key, t))
        chunks = tuple(zarray["chunks"])
        leaf_jobs = [(t, index, chunks, values.get(_chunk_key(name, index)))
                     for index in _chunk_indices(t.shape, chunks)]
        if any(v is None for *_, v in leaf_jobs):  # zarr's fill value (orbax stores every chunk)
            fill = zarray.get("fill_value")
            t.fill_(0 if fill is None else fill)
        jobs += [j for j in leaf_jobs if j[3] is not None]

    def fill(job):
        t, index, chunks, value = job
        if tuple(t.shape) == chunks or not chunks:  # one chunk: decoded in place
            zstd.decompress(store.read(value), out=_as_bytes(t))
            return
        n = math.prod(chunks) * t.element_size()
        raw = zstd.decompress(store.read(value), n)
        chunk = torch.frombuffer(raw, dtype=torch.uint8).view(t.dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, t.shape))
        t[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]

    with ThreadPoolExecutor(_threads()) as pool:
        for _ in pool.map(fill, jobs):
            pass
    return out


def _empty_array(name: str, zarray: dict) -> torch.Tensor:
    if zarray.get("zarr_format") != 2 or zarray.get("order", "C") != "C":
        raise ocdbt.OcdbtFormatError(f"{name}: zarr v2 in C order is read here, not {zarray}")
    if zarray.get("filters"):
        raise ocdbt.OcdbtFormatError(f"{name}: zarr filters {zarray['filters']}")
    compressor = zarray.get("compressor") or {}
    if compressor.get("id") != "zstd":
        raise ocdbt.OcdbtFormatError(f"{name}: compressor {compressor}, zstd is read here")
    dtype = _DTYPES.get(zarray["dtype"])
    if dtype is None:
        raise ocdbt.OcdbtFormatError(f"{name}: zarr dtype {zarray['dtype']}")
    return torch.empty(tuple(zarray["shape"]), dtype=dtype)
