"""Offline position-embedding resize
(`aigv_assessor_tpu/tools/resize_pos_embed.py`): torch's bicubic
interpolation (A = -0.75, align_corners=False) of the grid part of the ViT
position embedding to a new image size; the cls position is kept. As JAX's
tool, it applies `ops/resize.bicubic_matrix` (fp32 weights) to the grid in
float64 and rounds once to the embedding's dtype, so both tools write the
same bits. Containers by suffix (`.msgpack`, `.safetensors`).

Usage:
  python -m aigv_assessor_torch.tools.resize_pos_embed \\
      --params params.msgpack --old_size 448 --new_size 336 --patch 14 --out resized.msgpack
"""

from __future__ import annotations

import argparse

import torch

from aigv_assessor_torch.models.loading import load_jax_params, save_jax_params
from aigv_assessor_torch.ops.resize import bicubic_matrix


def resize_pos_embed(pos_embed: torch.Tensor, old_size: int, new_size: int,
                     patch_size: int) -> torch.Tensor:
    """pos_embed [1, 1 + (old/p)^2, C] -> [1, 1 + (new/p)^2, C]."""
    old_side, new_side = old_size // patch_size, new_size // patch_size
    cls, grid = pos_embed[:, :1], pos_embed[:, 1:]
    c = grid.shape[-1]
    grid = grid.reshape(old_side, old_side, c).double()
    m = torch.from_numpy(bicubic_matrix(old_side, new_side)).double()
    grid = torch.einsum("hH,HWc,wW->hwc", m, grid, m).to(pos_embed.dtype)
    return torch.cat([cls, grid.reshape(1, new_side * new_side, c)], dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--old_size", type=int, required=True)
    ap.add_argument("--new_size", type=int, required=True)
    ap.add_argument("--patch", type=int, default=14)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    params = load_jax_params(args.params)
    emb = params.get("params", params)["vision_model"]["embeddings"]
    emb["position_embedding"] = resize_pos_embed(emb["position_embedding"], args.old_size,
                                                 args.new_size, args.patch)
    save_jax_params(args.out, params)
    print(f"resized pos embed {args.old_size}->{args.new_size}; wrote {args.out}")


if __name__ == "__main__":
    main()
