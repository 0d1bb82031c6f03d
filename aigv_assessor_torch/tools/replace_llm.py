"""Swap the language model inside a composite JAX parameter tree
(`aigv_assessor_tpu/tools/replace_llm.py`): the `language_model` subtree of
`--params` replaced by `--llm_params`' (its `language_model`, or the whole
tree where it has none). Containers by suffix (`.msgpack`, `.safetensors`).

Usage:
  python -m aigv_assessor_torch.tools.replace_llm \\
      --params params.msgpack --llm_params llm.msgpack --out swapped.msgpack
"""

from __future__ import annotations

import argparse

from aigv_assessor_torch.models.loading import load_jax_params, save_jax_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--llm_params", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    params = load_jax_params(args.params)
    llm = load_jax_params(args.llm_params)
    llm_tree = llm.get("params", llm)
    if "language_model" in llm_tree:
        llm_tree = llm_tree["language_model"]
    params.get("params", params)["language_model"] = llm_tree
    save_jax_params(args.out, params)
    print(f"replaced language_model; wrote {args.out}")


if __name__ == "__main__":
    main()
