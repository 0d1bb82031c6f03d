"""Shared pieces of tests/test_torch_phi3.py and tests/test_torch_decoders.py."""

import contextlib
import json
import os
from unittest import mock

from safetensors.numpy import save_file

from aigv_assessor_tpu.tools.convert_weights import load_torch_state_dict
from aigv_assessor_tpu.tools.make_synthetic_ckpt import make_synthetic_checkpoint


@contextlib.contextmanager
def jax_gates(value: str):
    """JAX's fused-feed switches, which its gates read from `os.environ`
    while tracing (tests/test_torch_fused_feeds.py)."""
    env = {**os.environ, "AIGV_FUSE_QUANT": value, "AIGV_QUANT_ROWS": value}
    with mock.patch.object(os, "environ", env):
        yield


def write_reference_checkpoint(directory: str, llm_config: dict, llm_weights: dict) -> str:
    """A reference-format checkpoint (one `model.safetensors` and a
    `config.json`) of the tiny stage-2 model whose decoder is `llm_config`
    (HF `config.json` fields) with `llm_weights` ({HF name under
    `language_model.`: numpy array}); the other towers are
    `make_synthetic_checkpoint`'s."""
    base = os.path.join(directory, "base")
    make_synthetic_checkpoint(base, stage=2, n_shards=1, seed=0)
    state = {k: v for k, v in load_torch_state_dict([base]).items()
             if not k.startswith("language_model.")}
    state.update(llm_weights)
    out = os.path.join(directory, "ref")
    os.makedirs(out)
    save_file({k: v.copy() for k, v in state.items()}, os.path.join(out, "model.safetensors"))
    with open(os.path.join(base, "config.json")) as f:
        config = json.load(f)
    config["llm_config"] = llm_config
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(config, f)
    return out
