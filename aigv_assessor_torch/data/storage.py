"""Pluggable remote-storage loaders: a jax-free copy of
`aigv_assessor_tpu/data/storage.py`.

Any URI scheme can register a fetch function returning the bytes of a path.
Nothing is registered by default; an `s3://` path raises unless a deployment
registers a handler:

    from aigv_assessor_torch.data import storage
    storage.register_loader("s3://", my_fetch_fn)  # fn(path) -> bytes
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional

_LOADERS: Dict[str, Callable[[str], bytes]] = {}


def register_loader(prefix: str, fn: Callable[[str], bytes]) -> None:
    _LOADERS[prefix] = fn


def get_loader(path: str) -> Optional[Callable[[str], bytes]]:
    for prefix, fn in _LOADERS.items():
        if path.startswith(prefix):
            return fn
    return None


def is_remote(path: str) -> bool:
    return "://" in path


def open_bytes(path: str) -> bytes:
    loader = get_loader(path)
    if loader is not None:
        return loader(path)
    if is_remote(path):
        raise IOError(
            f"no storage loader registered for {path!r}; call "
            "aigv_assessor_torch.data.storage.register_loader(prefix, fn)"
        )
    with open(path, "rb") as f:
        return f.read()


def open_image(path: str):
    """A PIL RGB image through the registered loader, or from the file."""
    from PIL import Image

    if get_loader(path) or is_remote(path):
        return Image.open(io.BytesIO(open_bytes(path))).convert("RGB")
    return Image.open(path).convert("RGB")
