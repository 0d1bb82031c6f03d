"""Extract the vision tower from a composite JAX parameter tree
(`aigv_assessor_tpu/tools/extract_vit.py`): `{"params": {"vision_model":
...}}`, which `--vision_path` grafts. Containers by suffix (`.msgpack`,
`.safetensors`).

Usage:
  python -m aigv_assessor_torch.tools.extract_vit --params params.msgpack --out vit.msgpack
"""

from __future__ import annotations

import argparse

from aigv_assessor_torch.models.loading import load_jax_params, save_jax_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    params = load_jax_params(args.params)
    tree = params.get("params", params)
    save_jax_params(args.out, {"params": {"vision_model": tree["vision_model"]}})
    print(f"wrote vision tower to {args.out}")


if __name__ == "__main__":
    main()
