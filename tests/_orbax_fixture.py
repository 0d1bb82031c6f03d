"""A tiny stage-1 checkpoint written by the JAX package's trainer, for the
port's checkpoint tests, and the recorded SHA-256 of each of its leaves.

`JAX_PLATFORMS=cpu python -m tests._orbax_fixture` rebuilds both:
`AssessorConfig.tiny(stage=1)` in fp32 initialized from key 0, one
`Trainer` step on `batch(cfg, 2, 2)`, saved by JAX's `CheckpointManager`
at step 1 into `tests/data/orbax_stage1/`, and each leaf's dtype, shape
and hash into `tests/data/orbax_stage1.sha256.json`.
`tests/test_torch_orbax.py` runs the same function once per module, holds
its hashes to the recorded ones, and uses its trainer for the parity
steps; `chip_smoke.py` reads the committed directory on the card's machine
(without JAX) and checks every leaf against the recorded hash.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.mesh import MeshConfig, make_mesh
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.train import trainer as jtrainer
from aigv_assessor_tpu.train.checkpoint import CheckpointManager

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CHECKPOINT = os.path.join(DATA, "orbax_stage1")
HASHES = os.path.join(DATA, "orbax_stage1.sha256.json")
CTX = 7
T = 2
TEXT = 12
TOTAL_STEPS = 3
TRAIN = dict(learning_rate=2e-3, weight_decay=0.1, warmup_ratio=0.0,
             lr_scheduler_type="cosine", max_grad_norm=0.5)


def config() -> AssessorConfig:
    return AssessorConfig.tiny(stage=1).replace(img_context_token_id=CTX)


def batch(cfg, b: int, seed: int) -> dict:
    """Right-padded prompts with every context slot, frames, and labels on
    the last text tokens of each real row."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1: 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[1:, n - 3:] = False
    ids[1:, n - 3:] = 2
    labels = np.full((b, n), -100, np.int32)
    labels[:, n - 7:] = ids[:, n - 7:]
    labels[~mask] = -100
    return {"input_ids": ids,
            "pixel_values": rng.normal(size=(b, T, 56, 56, 3)).astype(np.float32),
            "attention_mask": mask, "labels": labels}


def leaf_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def leaf_hashes(state) -> dict:
    """{leaf name: {dtype, shape, sha256 of the C-order bytes}} of every
    array leaf of a host `TrainState`."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(state)[0]:
        x = np.array(x, order="C")  # ascontiguousarray would make a scalar 1-d
        out[leaf_name(path)] = {"dtype": x.dtype.name, "shape": list(x.shape),
                                "sha256": hashlib.sha256(x.tobytes()).hexdigest()}
    return out


def jax_run(out_dir: str, best: bool = False, output_dir: str = "/tmp") -> dict:
    """Initialize, take one step, save step 1 (and the best slot) under
    `out_dir`. -> {"trainer", "mesh", "model", "params" (the initial host
    tree), "state" (the host state after the step)}."""
    cfg = config()
    model = AIGVAssessor(cfg, Precision.fp32())
    b = batch(cfg, 1, 0)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.key(0), jnp.asarray(b["input_ids"]), jnp.asarray(b["pixel_values"])))
    params = jax.tree_util.tree_map(np.array, params)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1))
    jt = jtrainer.Trainer(model, params,
                          jtrainer.TrainConfig(grad_checkpoint=False, output_dir=output_dir,
                                               **TRAIN),
                          TOTAL_STEPS, mesh=mesh)
    step = jt.compiled_step()
    with mesh:
        jt.state, _ = step(jt.state, {k: jnp.asarray(v) for k, v in
                                      jtrainer.microbatch(batch(cfg, 2, 2), 1).items()},
                           jax.random.key(0))
    mgr = CheckpointManager(out_dir)
    mgr.save(1, jt.state, best=best)
    mgr.close()
    return {"trainer": jt, "mesh": mesh, "model": model, "params": params,
            "state": jax.device_get(jt.state)}


def main() -> None:
    if os.path.exists(CHECKPOINT):
        shutil.rmtree(CHECKPOINT)
    run = jax_run(CHECKPOINT)
    hashes = leaf_hashes(run["state"])
    with open(HASHES, "w") as f:  # one leaf a line
        f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                                    for k, v in sorted(hashes.items())) + "\n}\n")


if __name__ == "__main__":
    main()
