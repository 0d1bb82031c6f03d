"""Shared pieces of the CLI parity tests (`tests/test_torch_train_cli_*.py`,
`tests/test_torch_serve.py`): the JAX parameter tree both packages take,
the 8-GIF meta file of `tests/test_cli_e2e.py`, and the CLIs' output
files (logs, CSVs, checkpoints in JAX's orbax layout) read back."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

from aigv_assessor_tpu.cli import common as j_common

WORDS = ["excellent", "good", "fair", "poor", "bad"]
MOS = {"excellent": 90, "good": 70, "fair": 50, "poor": 30, "bad": 10}


def jit_init(model, args, config, seed=0):
    """JAX's `init_or_load_params` without a checkpoint, through one jitted
    init in place of the eager one (the same draws, one compile)."""
    ids = jnp.zeros((1, 64), jnp.int32)
    pixels = jnp.zeros((1, 4, *j_common._image_hw(config), 3), jnp.float32)
    return jax.jit(model.init)(jax.random.key(seed), ids, pixels)


def open_tree(params, lora_b_seed=None):
    """numpy leaves; the score head's last kernel non-negative, so that its
    ReLU stays open whatever the readout's sign (the earlier layers' mixed
    signs open part of theirs) and the readout reaches the score; with
    `lora_b_seed`, every `lora_b` drawn non-zero, so that every adapter has
    a gradient from the first step."""
    rng = np.random.default_rng(lora_b_seed)
    head = params["params"].get("mlpscore", {})
    last = f"fc{len(head)}"

    def edit(path, x):
        x, keys = np.asarray(x), [str(p.key) for p in path]
        if keys[-1] == "lora_b" and lora_b_seed is not None:
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if keys[-3:] == ["mlpscore", last, "kernel"]:
            return np.abs(x)
        return x
    return jax.tree_util.tree_map_with_path(edit, params)


def write_gif_meta(d):
    """8 GIFs of 10 frames at 64 x 48 under `d/videos`, one annotation for
    train and test with quality words and their MOS, and `d/meta.json`
    pointing at it -> the meta's path."""
    (d / "videos").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        frames = [Image.new("RGB", (64, 48), (int(rng.integers(0, 255)), 30 + i * 5, 60))
                  for _ in range(10)]
        p = d / "videos" / f"clip{i}.gif"
        frames[0].save(p, save_all=True, append_images=frames[1:], duration=100)
        w = WORDS[i % 5]
        rows.append({
            "video": f"videos/clip{i}.gif", "id": f"clip{i}.gif->{MOS[w]}", "mos": MOS[w],
            "conversations": [
                {"from": "human", "value": "How would you rate the static quality of this video? "},
                {"from": "gpt", "value": f"The static quality of the video is {w}."}],
        })
    ann = d / "ann.jsonl"
    ann.write_text("".join(json.dumps(r) + "\n" for r in rows))
    meta = d / "meta.json"
    meta.write_text(json.dumps({"smoke": {
        "root": str(d), "annotation_train": str(ann), "annotation_test": str(ann),
        "annotation": str(ann), "repeat_time": 1, "data_augment": False, "length": 8}}))
    return str(meta)


def read_log(out):
    """The records of `<out>/train_log.jsonl`."""
    with open(out / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def read_tree_by_name(item):
    """{leaf name: tensor} of an orbax item (a checkpoint's `default/`),
    read by the port."""
    from aigv_assessor_torch.utils import orbax_format

    return {orbax_format.leaf_name(k): t for k, t in orbax_format.read_tree(str(item))
            if t is not None}


def read_best(checkpoints):
    """{"step", "best_metric"} of a manager directory's best slot: the
    state's step, and the port's extras beside it."""
    from aigv_assessor_torch.train.checkpoint import EXTRAS_FILE

    with open(checkpoints / "best" / EXTRAS_FILE) as f:
        extras = json.load(f)
    return {"step": int(read_tree_by_name(checkpoints / "best" / "state")["step"]),
            "best_metric": extras["best_metric"]}


def assert_holds_tree(trainer, item):
    """The port trainer's whole state, as its checkpoints write it (every
    parameter and buffer, Adam's moments and counts, the step), equals the
    orbax item's leaves bit for bit."""
    import torch

    from aigv_assessor_torch.train.checkpoint import train_state_tree
    from aigv_assessor_torch.utils import orbax_format

    want = read_tree_by_name(item)
    got = {orbax_format.leaf_name(k): t
           for k, t in train_state_tree(trainer, trainer.state_dict()) if t is not None}
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
