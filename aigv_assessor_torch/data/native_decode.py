"""ctypes binding for the native ffmpeg decoder (`native/libvideodec.so` at
the root of the checkout): a jax-free copy of
`aigv_assessor_tpu/data/native_decode.py`, which loads the same library.

Host-side C++ replacement for the decord dependency: probes frame count and
fps, computes the reference's exact segment-middle indices (`get_index`,
`stage1_train.py:488-500`) and decodes the selected frames in a single
sequential pass, optionally resizing on the fly (SWS bicubic).

The library is built with `make -C native/` (g++ and the libav* headers). It
links against one ABI of libavformat / libavcodec / libavutil / libswscale;
on a machine without those, `ctypes.CDLL` raises OSError. Either way, a
library that is missing or does not load counts as absent: `available()` is
False, the reason is logged once, and `data/video.py` decodes with OpenCV.
This is the host's decoder, not a device fallback.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from aigv_assessor_torch.data.video import get_frame_indices

logger = logging.getLogger(__name__)

_LIB = None
_MISSING = False  # the library was looked for and is absent or did not load
_LOCK = threading.Lock()
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SO_PATH = os.path.join(_REPO_ROOT, "native", "libvideodec.so")


def _load():
    global _LIB, _MISSING
    with _LOCK:
        if _LIB is not None or _MISSING:
            return _LIB
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:  # not built, or its libav* libraries are not here
            _MISSING = True
            logger.warning("native video decoder unavailable (%s); decoding with OpenCV", e)
            return None
        lib.vd_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.vd_probe.restype = ctypes.c_int
        lib.vd_decode_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vd_decode_frames.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def probe(path: str) -> Tuple[int, float]:
    lib = _load()
    if lib is None:
        raise RuntimeError("libvideodec.so not built (make -C native/)")
    n = ctypes.c_int64()
    fps = ctypes.c_double()
    rc = lib.vd_probe(path.encode(), ctypes.byref(n), ctypes.byref(fps))
    if rc != 0:
        raise IOError(f"vd_probe failed ({rc}) for {path}")
    return int(n.value), float(fps.value)


def decode_at_indices(
    path: str,
    indices: np.ndarray,
    out_size: Optional[Tuple[int, int]] = None,  # (w, h); None = native
) -> List[np.ndarray]:
    """Decode specific frame indices; returns list of [H, W, 3] uint8."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libvideodec.so not built (make -C native/)")
    # indices must be sorted for the single-pass decoder; remember order
    order = np.argsort(indices, kind="stable")
    sorted_idx = np.ascontiguousarray(np.asarray(indices, np.int64)[order])
    n = len(sorted_idx)
    if out_size is not None:
        w, h = out_size
    else:
        w = h = 0
    if w == 0:
        # native size from the stream's codec parameters — no decode pass.
        # (The previous fallback decoded a probe frame into a worst-case
        # 1x4320x7680x3 buffer — ~95 MB of allocation churn per video on
        # the default out_size=None training/scoring path.)
        if hasattr(lib, "vd_probe_dims"):
            cw, ch = ctypes.c_int(), ctypes.c_int()
            rc = lib.vd_probe_dims(
                path.encode(), ctypes.byref(cw), ctypes.byref(ch)
            )
            if rc == 0:
                w, h = int(cw.value), int(ch.value)
    if w == 0:
        # old .so without vd_probe_dims (or no codecpar dims): decode the
        # first frame at native size to learn dims (buffer 8K max)
        max_w, max_h = 7680, 4320
        buf = np.empty((1, max_h, max_w, 3), np.uint8)
        nw, nh = ctypes.c_int(), ctypes.c_int()
        one = np.ascontiguousarray(sorted_idx[:1])
        rc = lib.vd_decode_frames(
            path.encode(),
            one.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            1,
            0,
            0,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(nw),
            ctypes.byref(nh),
        )
        if rc < 1:
            raise IOError(f"vd_decode_frames probe failed ({rc}) for {path}")
        w, h = int(nw.value), int(nh.value)

    out = np.empty((n, h, w, 3), np.uint8)
    nw, nh = ctypes.c_int(), ctypes.c_int()
    rc = lib.vd_decode_frames(
        path.encode(),
        sorted_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        w,
        h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(nw),
        ctypes.byref(nh),
    )
    if rc < n:
        raise IOError(f"vd_decode_frames wrote {rc}/{n} frames for {path}")
    # undo the sort
    result = [None] * n
    for pos, orig in enumerate(order):
        result[orig] = out[pos]
    return result


def sample_frames(
    path: str,
    num_segments: int,
    bound: Optional[Tuple[float, float]] = None,
    out_size: Optional[Tuple[int, int]] = None,
) -> List[np.ndarray]:
    """Probe + exact reference index math + single-pass decode."""
    n_frames, fps = probe(path)
    indices = get_frame_indices(
        num_segments, fps, max(n_frames - 1, 0), 0, bound
    )
    indices = np.clip(indices, 0, max(n_frames - 1, 0))
    return decode_at_indices(path, indices, out_size)
