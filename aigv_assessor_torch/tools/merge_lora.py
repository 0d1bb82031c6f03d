"""Merge LoRA adapters into their base weights
(`aigv_assessor_tpu/tools/merge_lora.py`): for every LoRA layer of a JAX
parameter tree, W <- W + (alpha / r) A B with alpha = 2r, then the adapter
leaves are dropped: a LoRA-free tree that a config with `use_*_lora = 0`
loads. The arithmetic is `models/lora.merged_weight`, the in-model merge's
(`merge_lora_`): the product in fp32 on `--device`, added to the base in
fp32 and rounded once to its dtype, layer by layer.

The containers follow the suffixes (`.msgpack`, flax's format; or
`.safetensors`, the tree flat by '/'-joined paths).

Usage:
  python -m aigv_assessor_torch.tools.merge_lora \\
      --params params.msgpack --config config.json --out merged.msgpack [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from aigv_assessor_torch.models.loading import (
    flatten_tree,
    load_jax_params,
    save_jax_params,
    unflatten_tree,
)
from aigv_assessor_torch.models.lora import LORA_LEAVES, merged_weight

# alpha = 2r in both of the reference's wrap methods, so alpha / r = 2
SCALING = 2.0


@torch.no_grad()
def merge_lora_tree(params: dict, backbone_r: int = 0, llm_r: int = 0,
                    device: torch.device | str = "cpu") -> dict:
    """The tree with every (lora_a, lora_b) pair folded into its
    `base/kernel` and dropped (a kernel [in, out], or stacked [L, in, out]
    with `lora_a` [L, in, r] and `lora_b` [L, r, out]). The ranks are read
    from the leaves; `backbone_r` / `llm_r` are JAX's unused arguments."""
    del backbone_r, llm_r
    flat = flatten_tree(params)
    out = {k: v for k, v in flat.items() if k.rpartition("/")[2] not in LORA_LEAVES}
    for key, a in flat.items():
        prefix, _, leaf = key.rpartition("/")
        if leaf != "lora_a":
            continue
        b_key, base_key = f"{prefix}/lora_b", f"{prefix}/base/kernel"
        if b_key not in flat or base_key not in flat:
            raise KeyError(f"incomplete LoRA triple at {key}")
        kernel = flat[base_key]
        a, b = a.to(device), flat[b_key].to(device)
        stacked = kernel.ndim == 3
        kernels = kernel if stacked else kernel[None]
        a, b = (a, b) if stacked else (a[None], b[None])
        merged = [merged_weight(k.to(device).t(), a_, b_, SCALING).t().to(kernel.dtype).cpu()
                  for k, a_, b_ in zip(kernels, a, b)]
        out[base_key] = torch.stack(merged) if stacked else merged[0]
    return unflatten_tree(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="where the products run (the in-model merge's device)")
    args = ap.parse_args(argv)
    save_jax_params(args.out, merge_lora_tree(load_jax_params(args.params), device=args.device))
    print(f"wrote merged params to {args.out}")


if __name__ == "__main__":
    main()
