"""zstd frames through the system's `libzstd.so.1`, called with `ctypes`.

The container of the JAX trainer's checkpoints (`utils/ocdbt.py`)
compresses every node, manifest and array chunk as one zstd frame. The
library is the only decoder: where it cannot be loaded, `compress` and
`decompress` raise `ZstdUnavailable`, which names it; nothing stands in
for it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Union

import numpy as np

LIBRARY = "libzstd.so.1"
# ZSTD_getFrameContentSize's answers when the size is not in the frame
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

Buffer = Union[bytes, bytearray, memoryview, np.ndarray]


class ZstdUnavailable(ImportError):
    """`libzstd.so.1` could not be loaded."""


class ZstdError(ValueError):
    """libzstd refused a frame."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _Lib:
    """The loaded library with its prototypes, opened at first use."""

    handle: Optional[ctypes.CDLL] = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.handle is None:
            cls.handle = cls._open()
        return cls.handle

    @staticmethod
    def _open() -> ctypes.CDLL:
        errors = []
        for name in (LIBRARY, ctypes.util.find_library("zstd")):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(f"{name}: {e}")
        else:
            raise ZstdUnavailable(
                f"{LIBRARY} could not be loaded ({'; '.join(errors) or 'not found'}); "
                "the checkpoint format compresses every file with zstd and this package "
                "has no other decoder")
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_compress.argtypes = [vp, size_t, vp, size_t, ctypes.c_int]
        lib.ZSTD_compress.restype = size_t
        lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_compressBound.argtypes = [size_t]
        lib.ZSTD_compressBound.restype = size_t
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_createDStream.argtypes = []
        lib.ZSTD_createDStream.restype = vp
        lib.ZSTD_freeDStream.argtypes = [vp]
        lib.ZSTD_freeDStream.restype = size_t
        lib.ZSTD_initDStream.argtypes = [vp]
        lib.ZSTD_initDStream.restype = size_t
        lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_OutBuffer),
                                              ctypes.POINTER(_InBuffer)]
        lib.ZSTD_decompressStream.restype = size_t
        return lib


def available() -> bool:
    try:
        _Lib.get()
    except ZstdUnavailable:
        return False
    return True


def _source(data: Buffer) -> np.ndarray:
    """`data` as a C-contiguous uint8 array (no copy where it already is
    one); the caller keeps it alive while the library reads it."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: Buffer, level: int = 1) -> bytes:
    """One zstd frame of `data` at `level`, its content size recorded."""
    lib = _Lib.get()
    src = _source(data)
    dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    n = _check(lib, lib.ZSTD_compress(dst.ctypes.data, dst.size, src.ctypes.data, src.size,
                                      level), "compress")
    return dst[:n].tobytes()


def frame_content_size(data: Buffer) -> Optional[int]:
    """The decompressed size a frame records, or None where it records none."""
    lib = _Lib.get()
    src = _source(data)
    n = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if n == _CONTENTSIZE_ERROR:
        raise ZstdError("zstd: not a zstd frame")
    return None if n == _CONTENTSIZE_UNKNOWN else int(n)


def decompress(data: Buffer, size: Optional[int] = None,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """The content of one frame as a uint8 array. `size`: the expected
    content size, checked where given; a frame that records no size (one
    written as a stream, as the checkpoints' nodes and tensorstore's
    chunks are) is decoded as a stream. `out`: a C-contiguous uint8 array
    of exactly the content's size to decode into (then returned)."""
    lib = _Lib.get()
    src = _source(data)
    if out is not None:
        if out.dtype != np.uint8 or out.ndim != 1 or not out.flags.c_contiguous:
            raise ValueError("zstd: `out` must be a contiguous 1-d uint8 array")
        size = out.size if size is None else size
        if out.size != size:
            raise ValueError(f"zstd: `out` holds {out.size} bytes, {size} were expected")
    recorded = frame_content_size(src)
    if recorded is None:
        got = _decompress_stream(lib, src, out)
        if size is not None and got.size != size:
            raise ZstdError(f"zstd: decoded {got.size} bytes, {size} were expected")
        return got
    if size is not None and recorded != size:
        raise ZstdError(f"zstd: the frame holds {recorded} bytes, {size} were expected")
    dst = np.empty(recorded, np.uint8) if out is None else out
    n = _check(lib, lib.ZSTD_decompress(dst.ctypes.data, recorded, src.ctypes.data, src.size),
               "decompress")
    if n != recorded:
        raise ZstdError(f"zstd: decoded {n} bytes, {recorded} were expected")
    return dst


def _decompress_stream(lib: ctypes.CDLL, src: np.ndarray,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """One frame of unrecorded size, through the streaming decoder: into
    `out` (which must hold it exactly), else into buffers as it comes."""
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "init")
        parts = []
        inb = _InBuffer(src.ctypes.data, src.size, 0)
        outb = None
        while True:
            if out is not None:
                if outb is None:
                    outb = _OutBuffer(out.ctypes.data, out.size, 0)
                elif outb.pos == outb.size:
                    raise ZstdError(f"zstd: the frame holds more than {out.size} bytes")
                buf = out
            else:
                buf = np.empty(max(4 * src.size, 1 << 16), np.uint8)
                outb = _OutBuffer(buf.ctypes.data, buf.size, 0)
            start = outb.pos
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "decompress")
            if out is None:
                parts.append(buf[start: outb.pos])
            if left == 0:  # the frame is complete
                break
            if inb.pos == inb.size and outb.pos < outb.size:
                raise ZstdError("zstd: the frame is truncated")
        if inb.pos != inb.size:
            raise ZstdError("zstd: bytes after the frame")
        if out is not None:
            return out[: outb.pos]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
    finally:
        lib.ZSTD_freeDStream(stream)
