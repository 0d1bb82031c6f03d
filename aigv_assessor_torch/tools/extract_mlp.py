"""Extract the projectors from a composite JAX parameter tree
(`aigv_assessor_tpu/tools/extract_mlp.py`): `{"mlp1": ..., "motion_mlp":
...}` (`motion_mlp` None where the tree has none; a `.safetensors` file
leaves it out), which `--mlp_path` grafts. Containers by suffix.
"""

from __future__ import annotations

import argparse

from aigv_assessor_torch.models.loading import load_jax_params, save_jax_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", required=True)
    ap.add_argument("--out", default="mlp_projector.msgpack")
    args = ap.parse_args(argv)
    params = load_jax_params(args.params)
    tree = params.get("params", params)
    save_jax_params(args.out, {"mlp1": tree["mlp1"], "motion_mlp": tree.get("motion_mlp")})
    print(f"wrote projector to {args.out}")


if __name__ == "__main__":
    main()
