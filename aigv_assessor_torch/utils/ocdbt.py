"""The OCDBT key-value store that orbax writes a checkpoint into, read and
written without tensorstore.

An orbax checkpoint directory (`<dir>/<step>/default/`, or a `best/state/`
slot) holds one store: a root `manifest.ocdbt` whose B+-tree lives in
`d/<name>` and whose values live in the process-0 store's data files,
`ocdbt.process_0/d/<name>` (that store has its own `manifest.ocdbt` over the
same values). `utils/orbax_format.py` puts zarr v2 arrays on top.

The layout, as derived from the files that tensorstore 0.1.80 writes under
orbax 0.11.32 and from stores written with chosen configurations
(compression off, small node limits):

- Integers are LEB128 varints unless stated. Every manifest and B+-tree
  node is one *encoded file* (or one such record inside a data file):
  magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node), the
  record's whole length (uint64 little-endian), format version (varint 0),
  compression (varint: 0 none, 1 zstd), the body (one zstd frame where
  compressed), and a CRC-32C (Castagnoli) of every byte before it,
  uint32 little-endian.
- Manifest body: the config (uuid: 16 bytes; manifest kind: 0 single;
  max_inline_value_bytes; max_decoded_node_bytes; version_tree_arity_log2:
  one byte; compression: 0 none, or 1 zstd followed by its level as a
  little-endian int32), then a data-file table, the versions, and the
  version-tree nodes (a count; orbax writes 0). The versions are columns
  over their count: generation numbers, root heights (one byte each), the
  roots' data-file ids, offsets and lengths, then the statistics num_keys,
  num_tree_bytes, num_indirect_value_bytes, and the commit times (uint64
  little-endian nanoseconds). An empty tree's root has offset and length
  2**64 - 1.
- Data-file table: a count n; the lengths of the prefix each path shares
  with the one before (n - 1 values); the suffix lengths (n); the
  base-path lengths (n); the suffixes. A path is resolved from the store's
  directory; its first `base_path_length` bytes are the base path
  (`ocdbt.process_0/` where the root's tree points into the process-0
  store).
- A B+-tree node body: its height (one byte, 0 for a leaf), a data-file
  table, the entry count n, the keys' shared-prefix lengths (n - 1) and
  suffix lengths (n), then, in an interior node only, each child's
  subtree-common-prefix length (n), then the key suffixes.
  - A leaf continues with the value lengths (n) and kinds (n: 0 inline,
    1 indirect), the data-file ids and then the offsets of the indirect
    values (their lengths are the value lengths), then the inline values
    concatenated.
  - An interior node continues with its children's data-file ids (n),
    offsets (n) and lengths (n), then their num_keys, num_tree_bytes and
    num_indirect_value_bytes (n each).
  - Keys are relative: a node under an interior entry stores its keys
    without the entry's key prefix of its subtree-common-prefix length
    (and without every such prefix above it).
- Indirect values are raw bytes at (data file, offset, length); orbax
  inlines values of at most 1024 bytes (`max_inline_value_bytes`), which
  takes every `.zarray` and the small chunks.

The writer writes the layout orbax writes with the fewest parts: one
version, one leaf as the root (orbax's own limit, `max_decoded_node_bytes`
of 10**8, holds any of this repository's trees in one node), the indirect
values in one data file of the process-0 store, zstd on the nodes.
"""

from __future__ import annotations

import io
import os
import struct
import time
import uuid as uuidlib
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from aigv_assessor_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
VALUE_INLINE, VALUE_INDIRECT = 0, 1
MANIFEST_SINGLE = 0
_NO_OFFSET = 2**64 - 1
_HEADER = 4 + 8  # magic, length; then the version and compression varints
_CRC = 4

# what orbax configures (orbax/checkpoint/_src/serialization/tensorstore_utils.py)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_ZSTD_LEVEL = 0
PROCESS_DIR = "ocdbt.process_0/"


class OcdbtFormatError(ValueError):
    """A file that is not the store this module reads."""


# ------------------------------------------------------------------ bytes --

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtFormatError(f"{self.what}: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtFormatError(f"{self.what}: truncated")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtFormatError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def decode_record(record: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded manifest or node, its header and CRC checked."""
    if len(record) < _HEADER + 2 + _CRC:
        raise OcdbtFormatError(f"{what}: {len(record)} bytes is too short")
    got_magic, length = struct.unpack(">I", record[:4])[0], struct.unpack("<Q", record[4:12])[0]
    if got_magic != magic:
        raise OcdbtFormatError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(record):
        raise OcdbtFormatError(f"{what}: the header says {length} bytes, the record has "
                               f"{len(record)}")
    (crc,) = struct.unpack("<I", record[-_CRC:])
    if crc != crc32c(record[:-_CRC]):
        raise OcdbtFormatError(f"{what}: CRC-32C mismatch")
    r = _Reader(record[:-_CRC], what)
    r.pos = _HEADER
    version, compression = r.varint(), r.varint()
    if version != FORMAT_VERSION:
        raise OcdbtFormatError(f"{what}: format version {version}")
    body = record[r.pos:-_CRC]
    if compression == COMPRESSION_ZSTD:
        return zstd.decompress(body).tobytes()
    if compression != COMPRESSION_NONE:
        raise OcdbtFormatError(f"{what}: compression {compression}")
    return body


def encode_record(body: bytes, magic: int) -> bytes:
    """One encoded manifest or node, zstd-compressed at `NODE_ZSTD_LEVEL`
    as orbax writes it."""
    head = _varint(FORMAT_VERSION) + _varint(COMPRESSION_ZSTD)
    body = zstd.compress(body, NODE_ZSTD_LEVEL)
    length = _HEADER + len(head) + len(body) + _CRC
    out = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return out + struct.pack("<I", crc32c(out))


# ------------------------------------------------------------- the parts --

@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int = MANIFEST_SINGLE
    max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES
    max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES
    version_tree_arity_log2: int = VERSION_TREE_ARITY_LOG2
    zstd_level: Optional[int] = NODE_ZSTD_LEVEL  # None: no compression

    def encode(self) -> bytes:
        """The writer's config: its nodes are zstd-compressed."""
        return (self.uuid + _varint(self.manifest_kind) + _varint(self.max_inline_value_bytes)
                + _varint(self.max_decoded_node_bytes) + bytes([self.version_tree_arity_log2])
                + _varint(COMPRESSION_ZSTD) + struct.pack("<i", NODE_ZSTD_LEVEL))

    @classmethod
    def decode(cls, r: _Reader) -> "Config":
        uuid = r.take(16)
        kind, inline, node_bytes = r.varint(), r.varint(), r.varint()
        arity = r.byte()
        method = r.varint()
        if method == COMPRESSION_ZSTD:
            level = struct.unpack("<i", r.take(4))[0]
        elif method == COMPRESSION_NONE:
            level = None
        else:
            raise OcdbtFormatError(f"{r.what}: compression method {method}")
        return cls(uuid, kind, inline, node_bytes, arity, level)


def _read_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    r.varints(n)  # the base-path lengths: where the base path ends in each path
    paths: List[str] = []
    prev = b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtFormatError(f"{r.what}: data-file path prefix {p} > {len(prev)}")
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode())
    return paths


def _file_table(paths: Sequence[str], base_lengths: Sequence[int]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = [_common(a, b) for a, b in zip(raw, raw[1:])]
    suffix = [len(p) - q for p, q in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(suffix) + _varints(base_lengths)
            + b"".join(p[q:] for p, q in zip(raw, [0] + prefix)))


def _common(a: bytes, b: bytes) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _read_keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys: List[bytes] = []
    prev = b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtFormatError(f"{r.what}: key prefix {p} > {len(prev)}")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class Ref:
    """An indirect value or a node: `length` bytes at `offset` of a data
    file, by its path relative to the store's directory."""

    path: str
    offset: int
    length: int


Value = Union[bytes, Ref]


@dataclass
class Manifest:
    config: Config
    root: Optional[Ref]  # None: the tree is empty
    height: int
    generation: int


def read_manifest(directory: str) -> Manifest:
    path = os.path.join(directory, "manifest.ocdbt")
    with open(path, "rb") as f:
        body = decode_record(f.read(), MANIFEST_MAGIC, path)
    r = _Reader(body, path)
    config = Config.decode(r)
    if config.manifest_kind != MANIFEST_SINGLE:
        raise OcdbtFormatError(f"{path}: manifest kind {config.manifest_kind}; orbax writes "
                               "the single-file kind, the only one read here")
    files = _read_file_table(r)
    n = r.varint()
    if n == 0:
        raise OcdbtFormatError(f"{path}: no version")
    gens, heights = r.varints(n), [r.byte() for _ in range(n)]
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    r.varints(3 * n)  # statistics: num_keys, num_tree_bytes, num_indirect_value_bytes
    r.take(8 * n)  # commit times
    if r.varint():
        raise OcdbtFormatError(f"{path}: version-tree nodes, which orbax does not write")
    r.done()
    last = max(range(n), key=lambda i: gens[i])
    root = None if offsets[last] == _NO_OFFSET else Ref(files[ids[last]], offsets[last],
                                                        lengths[last])
    return Manifest(config, root, heights[last], gens[last])


# --------------------------------------------------------------- reading --

class Store:
    """A read-only OCDBT store: `items()` walks the B+-tree of its newest
    version in key order; `read(value)` gives a value's bytes."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self.manifest = read_manifest(self.directory)

    def _bytes(self, ref: Ref) -> bytes:
        path = os.path.join(self.directory, ref.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtFormatError(f"{path}: {ref.length} bytes at {ref.offset} run past the end")
        return data

    def read(self, value: Value) -> bytes:
        return value if isinstance(value, bytes) else self._bytes(value)

    def items(self) -> Iterator[Tuple[str, Value]]:
        m = self.manifest
        if m.root is not None:
            yield from self._node(m.root, m.height, b"")

    def _node(self, ref: Ref, height: int, prefix: bytes) -> Iterator[Tuple[str, Value]]:
        what = f"{os.path.join(self.directory, ref.path)}@{ref.offset}"
        r = _Reader(decode_record(self._bytes(ref), NODE_MAGIC, what), what)
        if r.byte() != height:
            raise OcdbtFormatError(f"{what}: node height differs from its parent's record")
        files = _read_file_table(r)
        n = r.varint()
        keys, common = _read_keys(r, n, interior=height > 0)
        if height > 0:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            r.done()
            for key, c, i, o, ln in zip(keys, common, ids, offsets, lengths):
                yield from self._node(Ref(files[i], o, ln), height - 1, prefix + key[:c])
            return
        lengths, kinds = r.varints(n), r.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == VALUE_INDIRECT]
        if any(k not in (VALUE_INLINE, VALUE_INDIRECT) for k in kinds):
            raise OcdbtFormatError(f"{what}: value kind outside 0 / 1")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {i: Ref(files[f], o, lengths[i]) for i, f, o in zip(indirect, ids, offsets)}
        for i, key in enumerate(keys):
            value = refs[i] if i in refs else r.take(lengths[i])
            yield (prefix + key).decode(), value
        r.done()


# --------------------------------------------------------------- writing --

class Writer:
    """Writes one store at `directory` (which must not hold one): `put`
    each key once, in any order, then `close()`. Values above
    `max_inline_value_bytes` go to one data file of the process-0 store as
    they come; `close` writes the leaf that holds every key, the root
    manifest and the process-0 one."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self.config = Config(uuid=uuidlib.uuid4().bytes)
        self.data_name = "d/" + uuidlib.uuid4().hex
        for sub in ("d", PROCESS_DIR + "d"):
            os.makedirs(os.path.join(self.directory, sub), exist_ok=True)
        if os.path.exists(os.path.join(self.directory, "manifest.ocdbt")):
            raise FileExistsError(f"{self.directory} already holds a store")
        self._data = open(os.path.join(self.directory, PROCESS_DIR, self.data_name), "wb")
        self._offset = 0
        self._values: Dict[bytes, Union[bytes, Tuple[int, int]]] = {}

    def put(self, key: str, value: bytes) -> None:
        k = key.encode()
        if k in self._values:
            raise KeyError(f"{key} written twice")
        if len(value) <= self.config.max_inline_value_bytes:
            self._values[k] = bytes(value)
            return
        self._data.write(value)
        self._values[k] = (self._offset, len(value))
        self._offset += len(value)

    def close(self) -> None:
        self._data.close()
        keys = sorted(self._values)
        indirect = sum(v[1] for v in self._values.values() if isinstance(v, tuple))
        stats = (len(keys), indirect)
        # the process-0 store's own tree, then the root's, both over the same values
        for where, base in ((os.path.join(self.directory, PROCESS_DIR), ""),
                            (self.directory, PROCESS_DIR)):
            if not keys:  # an empty tree has no root node
                self._manifest(where, "", None, stats)
                continue
            node = encode_record(self._leaf(keys, base), NODE_MAGIC)
            name = "d/" + uuidlib.uuid4().hex
            with open(os.path.join(where, name), "wb") as f:
                f.write(node)
            self._manifest(where, name, len(node), stats)

    def _leaf(self, keys: List[bytes], base: str) -> bytes:
        values = [self._values[k] for k in keys]
        indirect = [v for v in values if isinstance(v, tuple)]
        out = io.BytesIO()
        out.write(bytes([0]))  # height: a leaf
        out.write(_file_table([base + self.data_name], [len(base)]) if indirect else _varint(0))
        n = len(keys)
        prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
        out.write(_varint(n) + _varints(prefix))
        out.write(_varints(len(k) - p for k, p in zip(keys, [0] + prefix)))
        out.write(b"".join(k[p:] for k, p in zip(keys, [0] + prefix)))
        out.write(_varints(v[1] if isinstance(v, tuple) else len(v) for v in values))
        out.write(_varints(VALUE_INDIRECT if isinstance(v, tuple) else VALUE_INLINE
                           for v in values))
        out.write(_varints(0 for _ in indirect) + _varints(v[0] for v in indirect))
        out.write(b"".join(v for v in values if isinstance(v, bytes)))
        body = out.getvalue()
        if len(body) > self.config.max_decoded_node_bytes:
            raise ValueError(f"{len(keys)} keys need a node of {len(body)} bytes, above the "
                             f"store's limit of {self.config.max_decoded_node_bytes}")
        return body

    def _manifest(self, where: str, node: str, node_len: Optional[int],
                  stats: Tuple[int, int]) -> None:
        """`node_len` None: the empty tree, whose root is (file "", no offset)."""
        num_keys, indirect = stats
        root = (0, 0, node_len) if node_len is not None else (0, _NO_OFFSET, _NO_OFFSET)
        body = (self.config.encode() + _file_table([node], [0])
                + _varint(1)  # one version
                + _varint(1) + bytes([0])  # generation 1, a leaf as the root
                + _varints(root)  # data file 0, offset, length
                + _varints((num_keys, node_len or 0, indirect))
                + struct.pack("<Q", time.time_ns())
                + _varint(0))  # no version-tree nodes
        with open(os.path.join(where, "manifest.ocdbt"), "wb") as f:
            f.write(encode_record(body, MANIFEST_MAGIC))

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self._data.close()
