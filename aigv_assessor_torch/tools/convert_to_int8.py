"""Int8 / int4 weight export (`aigv_assessor_tpu/tools/convert_to_int8.py`),
on trees of torch tensors in the JAX layout.

Per-output-channel symmetric quantization of the dense kernels of a JAX
parameter tree, stored as {values int8, scales fp32}: `kernel` [in, out]
(or stacked [L, in, out]) becomes `kernel_int8` + `kernel_scale`, or, with
`--bits 4`, `kernel_int4` (two values a byte along the in axis, low nibble
first) + `kernel_scale4` + the `kernel_in_dim` scalar; `--dequantize` turns
either back into fp32 kernels. The arithmetic is the port's quantizers'
(`ops/w8a8.quantize_kernel`, `ops/int8_matmul.quantize_kernel_int4` and
their dequantizers), which the serving builds use too
(`models/loading.load_weights_`); on an fp32 tree it gives JAX's bytes.

The file's container follows its suffix: `.msgpack` (flax's format, read and
written without flax) or `.safetensors` (the tree flat by '/'-joined paths).

Usage:
  python -m aigv_assessor_torch.tools.convert_to_int8 \\
      --params params.msgpack --out int8.msgpack [--bits 4|8] [--scope language_model]
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from aigv_assessor_torch.models.loading import (
    flatten_tree,
    load_jax_params,
    save_jax_params,
    unflatten_tree,
)
from aigv_assessor_torch.ops import int8_matmul, w8a8


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _rows(w: torch.Tensor) -> torch.Tensor:
    """[..., in, out] -> [prod(...) * out, in]: one row per output channel."""
    return w.transpose(-1, -2).reshape(-1, w.shape[-2])


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] (or stacked [L, in, out]) -> int8 values + per-out-channel
    fp32 scale ([out] or [L, out])."""
    q, scale = w8a8.quantize_kernel(_rows(w))
    lead = w.shape[:-2] + (w.shape[-1],)
    return q.reshape(lead + (w.shape[-2],)).transpose(-1, -2).contiguous(), scale.reshape(lead)


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    rows = int8_matmul.dequantize_kernel(_rows(q), scale.reshape(-1), dtype)
    return rows.reshape(q.shape[:-2] + (q.shape[-1], q.shape[-2])).transpose(-1, -2).contiguous()


def quantize_kernel_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """4-bit per-channel symmetric, two values packed per byte along the in
    axis (an odd in axis padded with a zero) -> (int8 [..., ceil(in/2),
    out], fp32 [..., out])."""
    packed, scale = int8_matmul.quantize_kernel_int4(_rows(w))
    lead = w.shape[:-2] + (w.shape[-1],)
    return (packed.reshape(lead + (packed.shape[-1],)).transpose(-1, -2).contiguous(),
            scale.reshape(lead))


def dequantize_kernel_int4(packed: torch.Tensor, scale: torch.Tensor, in_dim: int,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    rows = int8_matmul.dequantize_kernel_int4(_rows(packed), scale.reshape(-1), in_dim, dtype)
    lead = packed.shape[:-2] + (packed.shape[-1],)
    return rows.reshape(lead + (in_dim,)).transpose(-1, -2).contiguous()


def quantize_tree(params: dict, min_size: int = 4096, scope="language_model",
                  exclude: tuple = (), only_base: bool = False) -> dict:
    """Quantize the dense kernels under `scope` (a path component; '' every
    eligible kernel; a tuple several towers), none under a component in
    `exclude`: each kernel of rank 2 or 3 with at least `min_size` values,
    or with `only_base` each `base` kernel of a LoRA layer whatever its
    size. Every other leaf is kept."""
    scopes = (scope,) if isinstance(scope, str) else tuple(scope)
    out = {}
    n_q = 0
    for key, v in flatten_tree(params).items():
        path = key.split("/")
        v = _as_tensor(v)
        in_scope = not any(scopes) or any(k in scopes for k in path)
        if exclude and any(k in exclude for k in path):
            in_scope = False
        is_base_kernel = path[-1] == "kernel" and v.ndim in (2, 3)
        if only_base:
            is_base_kernel = is_base_kernel and len(path) >= 2 and path[-2] == "base"
            size_ok = True
        else:
            size_ok = v.numel() >= min_size
        if in_scope and is_base_kernel and size_ok:
            prefix = key[: -len("kernel")]
            out[prefix + "kernel_int8"], out[prefix + "kernel_scale"] = quantize_kernel(v)
            n_q += 1
        else:
            out[key] = v
    print(f"quantized {n_q} kernels")
    return unflatten_tree(out)


def quantize_tree_int4(params: dict, min_size: int = 4096, scope: str = "language_model") -> dict:
    out = {}
    n_q = 0
    for key, v in flatten_tree(params).items():
        path = key.split("/")
        v = _as_tensor(v)
        in_scope = not scope or any(k == scope for k in path)
        if in_scope and path[-1] == "kernel" and v.ndim in (2, 3) and v.numel() >= min_size:
            prefix = key[: -len("kernel")]
            out[prefix + "kernel_int4"], out[prefix + "kernel_scale4"] = quantize_kernel_int4(v)
            out[prefix + "kernel_in_dim"] = torch.tensor(v.shape[-2], dtype=torch.int32)
            n_q += 1
        else:
            out[key] = v
    print(f"quantized {n_q} kernels to int4")
    return unflatten_tree(out)


def strip_int4_meta(params: dict) -> dict:
    """Drop the `kernel_in_dim` scalars (needed only to dequantize an odd in
    axis), as the serving tree holds none."""
    return unflatten_tree({k: v for k, v in flatten_tree(params).items()
                           if k.rpartition("/")[2] != "kernel_in_dim"})


def dequantize_tree(params: dict, dtype: torch.dtype = torch.float32) -> dict:
    flat = flatten_tree(params)
    out = {}
    for key, v in flat.items():
        prefix, _, name = key.rpartition("/")
        at = f"{prefix}/" if prefix else ""
        if name == "kernel_int8":
            out[at + "kernel"] = dequantize_kernel(v, flat[at + "kernel_scale"], dtype)
        elif name == "kernel_int4":
            in_dim = int(flat[at + "kernel_in_dim"])
            out[at + "kernel"] = dequantize_kernel_int4(v, flat[at + "kernel_scale4"], in_dim,
                                                        dtype)
        elif name in ("kernel_scale", "kernel_scale4", "kernel_in_dim"):
            continue
        else:
            out[key] = v
    return unflatten_tree(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--scope", default="language_model",
                    help="subtree to quantize ('' = everything eligible)")
    ap.add_argument("--dequantize", action="store_true",
                    help="reverse: int8/int4 file -> fp32 params")
    args = ap.parse_args(argv)
    params = load_jax_params(args.params)
    if args.dequantize:
        out = dequantize_tree(params)
    elif args.bits == 4:
        out = quantize_tree_int4(params, scope=args.scope)
    else:
        out = quantize_tree(params, scope=args.scope)
    save_jax_params(args.out, out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
