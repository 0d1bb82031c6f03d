"""Stage 1 of the port against the JAX package: the text loss, the
teacher-forced forward with logits, the stage-1 labels, the trainer's steps
and the memory-lean model build.

- `cross_entropy_loss` against JAX's (shifted, fp32 log-softmax, mean over
  the non-ignored tokens, a count of at least 1), 1e-6;
- the stage-1 forward (`AIGVAssessor.forward(labels=, position_ids=,
  motion_features=)`) on `AssessorConfig.tiny(stage=1)`: logits, hidden
  state and loss against JAX `__call__` at 2e-4, fp32 on the CPU, as
  tests/test_torch_models.py holds stage 2;
- `preprocess_internlm` (and the turn maskers) on the test tokenizer: ids,
  labels and masks equal to the JAX package's;
- two stage-1 steps (mlp1 and motion_mlp training, both towers frozen)
  against the JAX `Trainer`: loss and gradients to 2e-4, parameters to 1e-5,
  as tests/test_torch_train.py does for stage 2; the trained weights'
  artifact keyed and laid out as the JAX tree;
- the lean build: frozen weights made straight in bf16, bit-equal to the
  fp32 draw cast to bf16.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import numpy as np
import pytest
import torch
from flax import traverse_util
import jax
import jax.numpy as jnp

from aigv_assessor_torch.cli import stage1_train
from aigv_assessor_torch.cli.score import build_serving_model
from aigv_assessor_torch.cli.stage2_train import build_training_model
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.data import preprocess as tpre
from aigv_assessor_torch.data.tokenizer import build_test_tokenizer as t_tokenizer
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import cross_entropy_loss
from aigv_assessor_torch.models.loading import init_lora_, init_random_, jax_paths
from aigv_assessor_torch.models.loading import init_score_head_, state_dict_from_jax
from aigv_assessor_torch.train import trainer as ttrainer
from aigv_assessor_torch.train.checkpoint import extract_params
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.mesh import MeshConfig, make_mesh
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.data import preprocess as jpre
from aigv_assessor_tpu.data.tokenizer import build_test_tokenizer as j_tokenizer
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.internlm2 import cross_entropy_loss as jax_ce
from aigv_assessor_tpu.train import freeze as jfreeze
from aigv_assessor_tpu.train import trainer as jtrainer

TOL = 2e-4
GRAD_TOL = 2e-4
PARAM_TOL = 1e-5
CTX = 7
T = 2
TEXT = 12


def _batch(cfg, b, seed):
    """Right-padded prompts with every context slot, frames, and labels that
    keep the last text tokens of each real row (the rest -100)."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[1:, n - 3 :] = False
    ids[1:, n - 3 :] = 2
    labels = np.full((b, n), -100, np.int32)
    labels[:, n - 7 :] = ids[:, n - 7 :]
    labels[~mask] = -100
    return {
        "input_ids": ids,
        "pixel_values": rng.normal(size=(b, T, 56, 56, 3)).astype(np.float32),
        "attention_mask": mask,
        "labels": labels,
    }


def _to_torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    out["labels"] = out["labels"].long()
    return out


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params, JAX config, port config) at stage 1."""
    cfg = AssessorConfig.tiny(stage=1).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    b = _batch(cfg, 1, 0)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.key(0), jnp.asarray(b["input_ids"]), jnp.asarray(b["pixel_values"])))
    params = jax.tree_util.tree_map(np.array, params)
    tcfg = TorchConfig.tiny(stage=1).replace(img_context_token_id=CTX)
    return model, params, cfg, tcfg


def _port(setup):
    _, params, _, tcfg = setup
    port = TorchAssessor(tcfg, TorchPrecision.fp32(), grad_checkpoint=True)
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return port


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels[0, :5] = -100
    labels[2] = -100  # a row with nothing to count
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    none = np.full((3, 9), -100, np.int32)  # count clamped to 1: the loss is 0
    assert cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(none)).item() == 0.0
    assert float(jax_ce(jnp.asarray(logits), jnp.asarray(none))) == 0.0


def test_stage1_model_has_no_score_head(setup):
    _, params, _, tcfg = setup
    assert "mlpscore" not in params["params"]
    port = _port(setup)
    assert not hasattr(port, "mlpscore")
    assert not any(n.startswith("mlpscore") for n in port.state_dict())


@pytest.mark.parametrize("variant", ["plain", "position_ids", "motion_features"])
def test_stage1_forward_logits_and_loss_match(setup, variant):
    model, params, cfg, _ = setup
    port = _port(setup).eval()
    b = _batch(cfg, 2, 1)
    kw_j, kw_t = {}, {}
    n = b["input_ids"].shape[1]
    if variant == "position_ids":
        # the second row as if left-padded by 3; positions stay below the
        # rope table's length, S
        pos = np.maximum(np.arange(n)[None] - np.array([[0], [3]]), 0).astype(np.int32)
        kw_j["position_ids"], kw_t["position_ids"] = jnp.asarray(pos), torch.from_numpy(pos).long()
    if variant == "motion_features":
        feat = np.random.default_rng(2).normal(size=(2, cfg.motion.feature_dim)).astype(np.float32)
        kw_j["motion_features"] = jnp.asarray(feat)
        kw_t["motion_features"] = torch.from_numpy(feat)
    want = model.apply(params, jnp.asarray(b["input_ids"]), jnp.asarray(b["pixel_values"]),
                       jnp.asarray(b["attention_mask"]), labels=jnp.asarray(b["labels"]), **kw_j)
    tb = _to_torch(b)
    with torch.no_grad():
        got = port(tb["input_ids"], tb["pixel_values"], tb["attention_mask"],
                   labels=tb["labels"], **kw_t)
    assert set(got) == {"hidden", "logits", "ce_loss", "loss"} and got["logits"].dtype == torch.float32
    for key in ("hidden", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=TOL, atol=TOL)
    assert got["loss"].item() == pytest.approx(float(want["loss"]), rel=TOL)
    assert got["ce_loss"].item() == got["loss"].item()
    with torch.no_grad():  # logits only when asked for, or when labels are given
        bare = port(tb["input_ids"], tb["pixel_values"], tb["attention_mask"], **kw_t)
        asked = port(tb["input_ids"], tb["pixel_values"], with_logits=True, **kw_t)
    assert set(bare) == {"hidden"} and set(asked) == {"hidden", "logits"}
    torch.testing.assert_close(asked["logits"], got["logits"], rtol=0, atol=0)


def _conversations():
    q = "Frame1: <image>\nFrame2: <image>\nMotion Feature: <image>\nHow would you rate the static quality of this video?"
    return [
        [{"from": "human", "value": q}, {"from": "gpt", "value": "The static quality of the video is good."}],
        [{"from": "gpt", "value": "dropped"}, {"from": "human", "value": " " + q},
         {"from": "gpt", "value": "The static quality of the video is poor. "},
         {"from": "human", "value": "How would you rate the temporal smoothness of this video?"},
         {"from": "gpt", "value": "The temporal smoothness of the video is fair."}],
    ]


@pytest.mark.parametrize("fn,template", [("preprocess_internlm", "internlm2-chat"),
                                         ("preprocess_mpt", "Hermes-2"),
                                         ("preprocess_phi3", "phi3-chat")])
@pytest.mark.parametrize("max_len,group", [(400, False), (400, True), (40, False)])
def test_stage1_labels_match_jax(fn, template, max_len, group):
    """ids, labels (-100 outside the answers) and masks, padded, unpadded
    and truncated (the reference's count mismatch zeroes the labels)."""
    jt, tt = j_tokenizer(model_max_length=max_len), t_tokenizer(model_max_length=max_len)
    sources = _conversations()
    n_img = [3, 3, 1]
    want = getattr(jpre, fn)(template, sources, jt, n_img, group_by_length=group)
    got = getattr(tpre, fn)(template, sources, tt, n_img, group_by_length=group)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.input_ids, w.input_ids)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.attention_mask, w.attention_mask)
        assert g.mismatch == w.mismatch
    if fn == "preprocess_internlm" and max_len == 400:
        ids, labels = got[0].input_ids, got[0].labels
        answer = tt.decode([int(t) for t in ids[labels != -100]])
        assert answer.startswith("The static quality of the video is good.")
    for s in sources:
        assert tpre.render_conversation(template, s, True) == jpre.render_conversation(
            template, s, True)


def test_two_stage1_steps_match_the_jax_trainer(setup, tmp_path):
    """mlp1 and motion_mlp train on the CE with both towers frozen: mean loss
    and gradients of step 1 over 2 micro-batches, then the parameters after
    2 steps, then the trained weights' artifact."""
    model, params, cfg, _ = setup
    kw = dict(learning_rate=2e-3, weight_decay=0.1, warmup_ratio=0.0,
              lr_scheduler_type="cosine", gradient_accumulation_steps=2, max_grad_norm=0.5,
              output_dir=str(tmp_path))
    total_steps = 3
    batches = [_batch(cfg, 4, seed) for seed in (2, 3)]

    mesh = make_mesh(MeshConfig(data=1, fsdp=1))
    jt = jtrainer.Trainer(model, params, jtrainer.TrainConfig(grad_checkpoint=False, **kw),
                          total_steps, mesh=mesh)
    trainable, frozen = jfreeze.partition_params(jt.state.params, jt.trainable_mask)
    key = jax.random.key(0)

    @jax.jit
    def loss_and_grads(trainable, mb):
        return jax.value_and_grad(
            lambda t: jt._loss_fn(jfreeze.merge_params(t, frozen), mb, key)[0])(trainable)

    micro = [jtrainer.microbatch(b, 2) for b in batches]
    with mesh:
        per_mb = [loss_and_grads(trainable, {k: jnp.asarray(v[i]) for k, v in micro[0].items()})
                  for i in range(2)]
    want_loss = float(np.mean([float(l) for l, _ in per_mb]))
    flat = [{"/".join(k): np.asarray(v) for k, v in
             traverse_util.flatten_dict(g["params"]).items()} for _, g in per_mb]
    want_grads = {k: (flat[0][k] + flat[1][k]) / 2 for k in flat[0]}

    port = _port(setup)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    pt = ttrainer.Trainer(port, ttrainer.TrainConfig(**kw), total_steps)
    assert {n.split(".", 1)[0] for n in pt.trainable} == {"mlp1", "motion_mlp"}
    paths = jax_paths(port)
    mbs = [ttrainer.microbatch(_to_torch(b), 2) for b in batches]
    loss = pt.accumulate_gradients(mbs[0])
    assert loss.item() == pytest.approx(want_loss, rel=GRAD_TOL)
    grads = {n: p.grad.clone() for n, p in pt.trainable_parameters().items()}
    assert {paths[n][0] for n in grads} == set(want_grads)
    for n, g in grads.items():
        w = want_grads[paths[n][0]]
        w = w.T if paths[n][0].endswith("kernel") else w
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(np.abs(w).max()), err_msg=n)

    step = jt.compiled_step()
    with mesh:
        for m in micro:
            jt.state, jloss = step(jt.state, {k: jnp.asarray(v) for k, v in m.items()}, key)
    for m in mbs:
        ploss = pt.train_step(m)
    assert pt.step == int(jt.state.step) == 2
    assert ploss.item() == pytest.approx(float(jloss), rel=GRAD_TOL)
    after = {"/".join(k): np.asarray(v) for k, v in
             traverse_util.flatten_dict(jax.device_get(jt.state.params)["params"]).items()}
    for n, p in port.named_parameters():
        path, layer = paths[n]
        w = after[path] if layer is None else after[path][layer]
        w = w.T if path.endswith("kernel") and w.ndim == 2 else w
        if n in pt.trainable:
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=PARAM_TOL, err_msg=n)
            assert not torch.equal(p.detach(), before[n]), n
        else:
            assert torch.equal(p.detach(), before[n]), n
    art = extract_params(port, pt.trainable)
    assert set(art) == {paths[n][0] for n in pt.trainable}
    for path, t in art.items():  # the JAX tree's layout: kernels [in, out]
        np.testing.assert_allclose(t.numpy(), after[path], rtol=0, atol=PARAM_TOL, err_msg=path)


def test_stage1_train_steps_end_to_end(tmp_path):
    """`cli/stage1_train.train_steps` from uint8 frames and labels: losses
    logged, the towers untouched, the artifact written."""
    cfg = TorchConfig.tiny(stage=1).replace(img_context_token_id=CTX)
    tc = ttrainer.TrainConfig(output_dir=str(tmp_path), learning_rate=1e-3, warmup_ratio=0.0,
                              lr_scheduler_type="constant", num_train_epochs=2, save_steps=0)
    model = stage1_train.build_training_model(cfg, device="cpu",
                                              precision=TorchPrecision.fp32(), train_config=tc)
    assert model.config.stage == 1 and not hasattr(model, "mlpscore")
    b = _batch(cfg, 2, 4)
    px = np.random.default_rng(5).integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)
    batch = {"input_ids": torch.from_numpy(b["input_ids"]).long(),
             "pixels_u8": torch.from_numpy(px),
             "attention_mask": torch.from_numpy(b["attention_mask"]),
             "labels": torch.from_numpy(b["labels"]).long()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = stage1_train.train_steps(model, [batch, batch], tc)
    assert trainer.step == 4
    import json
    import os
    losses = [json.loads(line)["loss"] for line in open(tmp_path / "train_log.jsonl")]
    assert len(losses) == 4 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert os.path.exists(tmp_path / stage1_train.TRAINABLE_FILE)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]) == (n not in trainer.trainable), n


@pytest.mark.parametrize("stage", [1, 2])
def test_lean_build_is_bit_equal_to_fp32_then_cast(stage):
    """`build_serving_model` and `build_training_model` in bf16 draw each
    tensor in fp32 and store it rounded: the same bits as building the fp32
    model and casting it, trainable tensors kept fp32."""
    kw = dict(use_backbone_lora=2, use_llm_lora=2) if stage == 2 else {}
    cfg = TorchConfig.tiny(stage=stage, **kw)
    with torch.device("meta"):
        ref = TorchAssessor(cfg, TorchPrecision())
    ref = init_random_(ref.to_empty(device="cpu"), 3)
    assert {p.dtype for p in ref.parameters()} == {torch.float32}
    if stage == 2:
        init_score_head_(ref, 4)
    init_lora_(ref, 5)
    want = ref.state_dict()

    served = build_serving_model(cfg, device="cpu", seed=3)
    for n, t in served.state_dict().items():
        assert t.dtype == torch.bfloat16 or not want[n].is_floating_point(), n
        if "lora_" not in n and not n.startswith("mlpscore"):
            assert torch.equal(t, want[n].to(t.dtype)), n

    tc = ttrainer.TrainConfig()
    model = build_training_model(cfg, device="cpu", seed=3, train_config=tc)
    trainable = set(ttrainer.Trainer(model, tc, 1).trainable)
    for n, t in model.state_dict().items():
        want_dtype = torch.float32 if n in trainable else torch.bfloat16
        if want[n].is_floating_point():
            assert t.dtype == want_dtype, n
        assert torch.equal(t, want[n].to(t.dtype)), n
