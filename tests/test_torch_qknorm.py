"""The QK-normalized vision tower (InternViT-6B's layer: RMSNorm, q_norm /
k_norm over the flattened C, no qkv bias) against the JAX package, on a tiny
config with 5 heads.

One JAX parameter tree, made from a seed (its `lora_b`, `q_norm` / `k_norm`
weights and score head redrawn from numpy, so that every leaf matters), goes
through `state_dict_from_jax` into the port. fp32 on the CPU: the JAX
attention takes its XLA path, the port's the three-tensor kernel's plain
versions (`FlashAttention` under autograd). Tolerance 2e-4, as
tests/test_torch_models.py and tests/test_torch_train.py hold the rest of
the model: the ViT's output, the stage-2 loss and every adapter's and the
score head's gradient (relative to the leaf's largest magnitude).

Also: `load_reference_checkpoint` on a reference-format checkpoint of this
tower against the JAX converter, bit for bit. The tower under W8A8, int8
and int4: tests/test_torch_lora_quant.py.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import (
    jax_paths,
    load_reference_checkpoint,
    state_dict_from_jax,
)
from aigv_assessor_torch.ops.flash_attention import flash_attention_lse
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.tools.convert_weights import convert, load_torch_state_dict
from aigv_assessor_tpu.tools.make_synthetic_ckpt import (
    reference_config_dict,
    reference_state_dict,
    slowfast_state_dict,
    write_sharded_safetensors,
)

TOL = 2e-4
CTX = 7  # <IMG_CONTEXT> id
T = 2  # frames per video
TEXT = 10
QK_VISION = dict(hidden_size=40, intermediate_size=64, num_attention_heads=5,
                 norm_type="rms_norm", qk_normalization=True, qkv_bias=False,
                 initializer_factor=0.1)
LORA = dict(use_backbone_lora=2, use_llm_lora=2, lora_dropout=0.0)


def _configs(stage=2, **kw):
    cfg = AssessorConfig.tiny(stage=stage, **kw).replace(img_context_token_id=CTX)
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, **QK_VISION))
    tcfg = TorchConfig.tiny(stage=stage, **kw).replace(img_context_token_id=CTX)
    tcfg = tcfg.replace(vision=dataclasses.replace(tcfg.vision, **QK_VISION))
    return cfg, tcfg


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[1:, n - 3 :] = False
    return (ids, rng.normal(size=(b, T, 56, 56, 3)).astype(np.float32), mask,
            rng.uniform(0.2, 0.9, b).astype(np.float32))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, JAX config, port config)."""
    cfg, tcfg = _configs(**LORA)
    model = AIGVAssessor(cfg, Precision.fp32())
    ids, px, _, _ = _batch(cfg, 1, 0)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), jnp.asarray(ids),
                                                jnp.asarray(px)))
    rng = np.random.default_rng(1)
    flat = traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if k[-1] == "lora_b":  # zeros at init: lora_a would get no gradient
            flat[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        elif k[-2] in ("q_norm", "k_norm"):  # ones at init
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif "mlpscore" in k:  # positive, so that no ReLU of the head is shut
            flat[k] = rng.uniform(0.01, 0.1, v.shape).astype(np.float32)
        else:
            flat[k] = np.array(v)
    params = traverse_util.unflatten_dict(flat)
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return model, params, port.eval(), cfg, tcfg


def test_qk_norm_leaves_map_onto_the_jax_tree(pair):
    _, params, port, cfg, _ = pair
    paths = jax_paths(port)
    flat = {"/".join(k) for k in traverse_util.flatten_dict(params["params"])}
    for norm in ("q_norm", "k_norm"):
        for i in range(cfg.vision.num_hidden_layers):
            name = f"vision_model.layers.{i}.attn.{norm}.weight"
            assert paths[name] == (f"vision_model/layers/attn/{norm}/weight", i)
            assert paths[name][0] in flat
    attn = port.vision_model.layers[0].attn
    assert attn.qkv.bias is None and attn.qkv.heads is None and not attn.proj.head_major_in


def test_qk_norm_vit_matches(pair):
    """56 px -> 17 tokens padded to 24: the kv_valid tail mask is live."""
    model, params, port, _, _ = pair
    frames = np.random.default_rng(2).normal(size=(T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(frames), method=lambda m, x: m.vision_model(x))
    with torch.no_grad():
        got = port.vision_model(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_qk_norm_stage2_loss_and_lora_gradients_match(pair):
    """The stage-2 L1 loss and the gradient of every adapter (both towers)
    and of the score head, through K2's plain backward in the ViT."""
    model, params, port, cfg, _ = pair
    ids, px, mask, mos = _batch(cfg, 2, 3)
    trainable = {"/".join(k): v for k, v in traverse_util.flatten_dict(params["params"]).items()
                 if k[-1] in ("lora_a", "lora_b") or k[0] == "mlpscore"}

    def loss_fn(t):
        flat = traverse_util.flatten_dict(params["params"])
        flat.update({tuple(k.split("/")): v for k, v in t.items()})
        p = {"params": traverse_util.unflatten_dict(flat)}
        return model.apply(p, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                           mos=jnp.asarray(mos), with_logits=False)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        {k: jnp.asarray(v) for k, v in trainable.items()})
    paths = jax_paths(port)
    for n, p in port.named_parameters():
        p.requires_grad_(paths[n][0] in trainable)
        p.grad = None
    counted = flash_attention_lse.launches
    out = port(torch.from_numpy(ids).long(), torch.from_numpy(px), torch.from_numpy(mask),
               mos=torch.from_numpy(mos))
    out["loss"].backward()
    assert flash_attention_lse.launches == counted  # CPU: the plain versions
    assert out["loss"].item() == pytest.approx(float(want_loss), rel=TOL)
    seen = set()
    for n, p in port.named_parameters():
        path, layer = paths[n]
        if path not in trainable:
            assert p.grad is None, n
            continue
        want = np.asarray(want_grads[path])
        want = want if layer is None else want[layer]
        want = want.T if path.endswith("kernel") else want
        assert np.abs(want).max() > 0, n  # every trainable leaf is live
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=TOL, atol=TOL * scale, err_msg=n)
        seen.add(path)
    assert seen == set(trainable)
    assert any("/attn/qkv/" in p for p in seen) and any("/attn/proj/" in p for p in seen)


def test_load_reference_checkpoint_reads_the_qk_norm_leaves(tmp_path):
    """A reference-format checkpoint of the QK-normalized tower (no qkv or
    norm bias, `attn.q_norm` / `attn.k_norm` weights): the port's loader
    against the JAX converter, bit for bit."""
    cfg, tcfg = _configs()
    rng = np.random.default_rng(5)
    sd = reference_state_dict(cfg, rng)
    for i in range(cfg.vision.num_hidden_layers):
        p = f"vision_model.encoder.layers.{i}."
        for leaf in ("attn.qkv.bias", "norm1.bias", "norm2.bias"):
            del sd[p + leaf]
        for norm in ("q_norm", "k_norm"):
            sd[p + f"attn.{norm}.weight"] = rng.uniform(
                0.5, 1.5, cfg.vision.hidden_size).astype(np.float32)
    sd.update(slowfast_state_dict(cfg, rng))
    write_sharded_safetensors(sd, str(tmp_path), 2)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(reference_config_dict(cfg), f)
    port_cfg = TorchConfig.from_json(str(tmp_path / "config.json")).replace(
        stage=2, img_context_token_id=CTX)
    assert port_cfg.vision == tcfg.vision
    got = load_reference_checkpoint(str(tmp_path), port_cfg)
    want = state_dict_from_jax(convert(load_torch_state_dict([str(tmp_path)]), cfg), port_cfg)
    assert set(got) == set(want)
    assert "vision_model.layers.1.attn.k_norm.weight" in got
    for k, v in want.items():
        assert torch.equal(got[k], v.float()), k
    TorchAssessor(port_cfg, TorchPrecision.fp32()).load_state_dict(got, strict=True)

