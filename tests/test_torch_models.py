"""The port's models against the JAX package on `AssessorConfig.tiny(stage=2)`.

One JAX parameter tree, made from a seed, goes through
`models/loading.state_dict_from_jax` into the port, so both packages compute
the same function. Inputs come from numpy. Everything runs in fp32 on the
CPU, where the JAX attention takes its XLA reference path and the port's
takes the kernel's plain version; the tolerance is atol/rtol 2e-4, as the
JAX package's own differential tests hold (STATUS.md).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.cli.score import build_serving_model, score_batch, score_chunks
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.ops.preprocess import resize_normalize

TOL = 2e-4
CTX = 7  # <IMG_CONTEXT> id
T = 4  # frames per video
TEXT = 16  # text tokens after the context slots


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL
    )


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, JAX config) sharing one set of
    weights."""
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    rng = np.random.default_rng(0)
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(rng.integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return model, params, port.eval(), cfg


def _prompts(cfg, b, p, seed):
    """[B, P, N] prompt ids with every context slot, right-padded by a
    different amount per perspective, and their masks."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, p, n)).astype(np.int32)
    ids[:, :, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, p, n), bool)
    for j in range(p):
        mask[:, j, n - 3 * j :] = False
        ids[:, j, n - 3 * j :] = 2  # pad id
    return ids, mask


def _pixels(b, seed):
    return np.random.default_rng(seed).normal(size=(b, T, 56, 56, 3)).astype(np.float32)


def test_vit_matches(pair):
    """56 px -> 17 tokens, padded to 24: the kv_valid tail mask is live."""
    model, params, port, _ = pair
    frames = _pixels(1, 1).reshape(T, 56, 56, 3)
    want = model.apply(params, jnp.asarray(frames), method=lambda m, x: m.vision_model(x))
    with torch.no_grad():
        got = port.vision_model(torch.from_numpy(frames))
    _close(got, want)


def test_internlm2_hidden_matches(pair):
    model, params, port, cfg = pair
    embeds = np.random.default_rng(2).normal(size=(2, 21, cfg.llm.hidden_size))
    embeds = embeds.astype(np.float32)
    want = model.apply(
        params, jnp.asarray(embeds),
        method=lambda m, e: m.language_model(inputs_embeds=e, with_logits=False)[1],
    )
    with torch.no_grad():
        got = port.language_model(inputs_embeds=torch.from_numpy(embeds), with_logits=False)[1]
    _close(got, want)


def test_slowfast_features_match(pair):
    model, params, port, _ = pair
    frames = _pixels(2, 3)
    want = model.apply(params, jnp.asarray(frames), method=lambda m, x: m.slowfast_model(x))
    with torch.no_grad():
        got = port.slowfast_model(torch.from_numpy(frames))
    assert tuple(got.shape) == (2, 288)
    _close(got, want)


def test_forward_hidden_and_score_match(pair):
    """Teacher-forced stage-2 forward without logits (`__call__`)."""
    model, params, port, cfg = pair
    ids, mask = _prompts(cfg, 2, 2, 4)
    ids, mask = ids[:, 1], mask[:, 1]  # right-padded by 3
    px = _pixels(2, 5)
    want = model.apply(
        params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask), with_logits=False
    )
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(px), torch.from_numpy(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"])


@pytest.mark.parametrize("p", [1, 2])
def test_score_perspectives_matches(pair, p):
    """The slice as a whole: uint8 frames through the port's `score_batch`
    against the JAX CLI's normalize + `score_perspectives`, no shared prefix.
    Each perspective reads out at its own real length - 4."""
    model, params, port, cfg = pair
    ids, mask = _prompts(cfg, 2, p, 6 + p)
    px = np.random.default_rng(8).integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)
    pv = resize_normalize(jnp.asarray(px), size=56, dtype=jnp.float32)
    want = model.apply(
        params, jnp.asarray(ids), pv, jnp.asarray(mask), method="score_perspectives"
    )
    got = score_batch(
        port, torch.from_numpy(ids).long(), torch.from_numpy(px), torch.from_numpy(mask)
    )
    assert tuple(got.shape) == (2, p) and got.dtype == torch.float32
    _close(got, want)


def test_score_chunks_pads_tail_and_scales(pair):
    """Three videos at batch size 2: the tail chunk is padded, every video
    gets one row, scores are scaled by mos_scale."""
    _, _, port, cfg = pair
    ids, mask = _prompts(cfg, 1, 1, 9)
    videos = list(
        np.random.default_rng(10).integers(0, 256, (3, T, 56, 56, 3), dtype=np.uint8)
    )
    rows = score_chunks(port, [videos[:2], videos[2:]], ids[0], mask[0], batch_size=2,
                        mos_scale=50.0)
    want = score_batch(
        port, torch.from_numpy(np.tile(ids, (3, 1, 1))).long(),
        torch.from_numpy(np.stack(videos)), torch.from_numpy(np.tile(mask, (3, 1, 1))),
    )
    np.testing.assert_allclose(np.asarray(rows), want.numpy() * 50.0, rtol=1e-5, atol=1e-5)


def test_unported_serving_options_raise(pair):
    """W8A8, int8 and int4 are ported (tests/test_torch_w8a8.py,
    tests/test_torch_weight_only.py); combining W8A8 with a weight-only mode
    is refused. The shared prefix is ported too (tests/test_torch_generation.py):
    two prompts through `score_chunks` share it by default and score as they
    do in full. Stage 1 builds (tests/test_torch_stage1.py). What is still
    refused: Phi-3, tied embeddings."""
    _, _, port, cfg = pair
    tcfg = TorchConfig.tiny(stage=2)
    for flag in ("int8", "int4"):
        with pytest.raises(ValueError, match="w8a8 excludes"):
            build_serving_model(tcfg, device="cpu", w8a8=True, **{flag: True})
    ids, mask = _prompts(cfg, 1, 2, 11)
    video = np.zeros((T, 56, 56, 3), np.uint8)
    shared = score_chunks(port, [[video]], ids[0], mask[0], batch_size=1)
    full = score_chunks(port, [[video]], ids[0], mask[0], batch_size=1, shared_prefix=False)
    np.testing.assert_allclose(np.asarray(shared), np.asarray(full), rtol=1e-4, atol=1e-2)
    # stage 1 is ported (tests/test_torch_stage1.py): the model builds, without
    # the score head, as in JAX
    stage1 = TorchAssessor(TorchConfig.tiny(stage=1))
    assert stage1.config.stage == 1 and not hasattr(stage1, "mlpscore")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TorchAssessor(tcfg.replace(llm=dataclasses.replace(tcfg.llm,
                                                           architecture="Phi3ForCausalLM")))
    with pytest.raises(NotImplementedError, match="tied embeddings"):
        TorchAssessor(tcfg.replace(llm=dataclasses.replace(tcfg.llm, tie_word_embeddings=True)))


def test_state_dict_from_jax_rejects_mismatch(pair):
    _, params, _, _ = pair
    tcfg = TorchConfig.tiny(stage=2)
    tree = dict(params["params"])
    tree["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_jax({"params": tree}, tcfg)
    tree = {k: v for k, v in params["params"].items() if k != "mlpscore"}
    with pytest.raises(KeyError, match="mlpscore"):
        state_dict_from_jax({"params": tree}, tcfg)
    wider = TorchConfig.tiny(stage=2).replace(score_head_dims=(64, 16, 1))
    with pytest.raises(ValueError, match="mlpscore.fc1"):
        state_dict_from_jax(params, wider)
