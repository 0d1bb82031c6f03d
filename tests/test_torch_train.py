"""The port's stage-2 trainer against the JAX package's, on the tiny model.

One JAX parameter tree (LoRA rank 2 in the ViT, 4 in the LLM), made from a
seed and with its zero `lora_b` leaves and its score head redrawn from numpy
so that every trainable leaf has a gradient, goes through
`state_dict_from_jax` into the port. Everything is fp32 on the CPU, dropout
and drop path off on both sides (JAX's random bits cannot be matched), and
the port runs with per-layer checkpointing on.

Tolerances: loss and every trainable leaf's gradient to 2e-4 relative (of the
leaf's largest magnitude), the same as the forward differentials; the
trainable parameters after two optimizer steps to 1e-5 absolute (Adam divides
the gradient by its own magnitude, so a 2e-4 relative gradient error moves a
parameter by at most lr * 2e-4).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from aigv_assessor_torch.cli.score import build_serving_model, score_batch
from aigv_assessor_torch.cli.stage2_train import (
    LORA_FILE,
    build_training_model,
    train_steps,
)
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import init_lora_, jax_paths, state_dict_from_jax
from aigv_assessor_torch.models.lora import (
    LoRALinear,
    is_lora_param,
    lora_free_state_dict,
    merge_lora_,
    set_generator,
)
from aigv_assessor_torch.train import trainer as ttrainer
from aigv_assessor_torch.train.checkpoint import (
    CheckpointManager,
    extract_lora,
    load_lora_weights,
    save_lora_weights,
)
from aigv_assessor_torch.train.freeze import apply_freeze_, count_params, trainable_names
from aigv_assessor_torch.train.layer_decay import layer_decay_multipliers as torch_multipliers
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.mesh import MeshConfig, make_mesh
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.train import freeze as jfreeze
from aigv_assessor_tpu.train import trainer as jtrainer
from aigv_assessor_tpu.train.layer_decay import layer_decay_multipliers

GRAD_TOL = 2e-4
PARAM_TOL = 1e-5
CTX = 7  # <IMG_CONTEXT> id
T = 2  # frames per video
TEXT = 12
LORA = dict(use_backbone_lora=2, use_llm_lora=4, lora_dropout=0.0)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def _batch(cfg, b, seed):
    """Right-padded prompts with every context slot, frames and MOS / 100."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[1:, n - 3 :] = False
    ids[1:, n - 3 :] = 2
    return {
        "input_ids": ids,
        "pixel_values": rng.normal(size=(b, T, 56, 56, 3)).astype(np.float32),
        "attention_mask": mask,
        "mos": rng.uniform(0.2, 0.9, b).astype(np.float32),
    }


def _to_torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    return out


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params with live adapters and score head, JAX config,
    port config)."""
    cfg = AssessorConfig.tiny(stage=2, **LORA).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    b = _batch(cfg, 1, 0)
    params = jax.device_get(
        jax.jit(model.init)(jax.random.key(0), jnp.asarray(b["input_ids"]),
                            jnp.asarray(b["pixel_values"]))
    )
    rng = np.random.default_rng(1)
    flat = traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if k[-1] == "lora_b":  # zeros at init: lora_a would get no gradient
            flat[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        elif "mlpscore" in k:  # positive, so that no ReLU of the head is shut
            flat[k] = rng.uniform(0.01, 0.1, v.shape).astype(np.float32)
        else:
            flat[k] = np.array(v)
    params = traverse_util.unflatten_dict(flat)
    tcfg = TorchConfig.tiny(stage=2, **LORA).replace(img_context_token_id=CTX)
    return model, params, cfg, tcfg


def _port(setup, grad_checkpoint=True, **cfg_kw):
    _, params, _, tcfg = setup
    tcfg = tcfg.replace(**cfg_kw) if cfg_kw else tcfg
    port = TorchAssessor(tcfg, TorchPrecision.fp32(), grad_checkpoint=grad_checkpoint)
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return port


def _jax_leaf(flat, name, paths):
    """The JAX leaf of a port parameter, in the port's layout."""
    path, layer = paths[name]
    leaf = flat[path] if layer is None else flat[path][layer]
    return leaf.T if path.endswith("kernel") and leaf.ndim == 2 else leaf


def _assert_leaf_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL * scale, err_msg=name)


# ------------------------------------------------------------- name maps ---


def test_jax_paths_cover_the_jax_tree(setup):
    """Every state_dict name maps to one (JAX path, layer) and together they
    are the JAX tree, layer by layer; a round trip returns every value."""
    _, params, _, _ = setup
    port = _port(setup)
    flat = _flat(params["params"])
    paths = jax_paths(port)
    assert set(paths) == set(port.state_dict())
    want = set()
    for path, leaf in flat.items():
        stacked = "/layers/" in path
        want |= {(path, i) for i in range(leaf.shape[0])} if stacked else {(path, None)}
    assert set(paths.values()) == want and len(paths) == len(want)
    state = port.state_dict()
    for name in ("vision_model.layers.1.attn.qkv.lora_a", "language_model.layers.0.attention.wo.weight",
                 "mlpscore.fc2.weight", "mlp1.ln.weight", "language_model.tok_embeddings.weight"):
        np.testing.assert_array_equal(state[name].numpy(), _jax_leaf(flat, name, paths))


@pytest.mark.parametrize("stage,flags", [
    (2, {}),
    (1, {}),
    (1, dict(freeze_mlp=True, freeze_backbone=False)),
    (1, dict(freeze_llm=True, unfreeze_lm_head=True)),
    (1, dict(freeze_llm=False)),
])
def test_trainable_set_matches_make_trainable_mask(setup, stage, flags):
    _, params, _, _ = setup
    port = _port(setup)
    mask = _flat(jfreeze.make_trainable_mask(params, stage, **flags)["params"])
    paths = jax_paths(port)
    names = trainable_names(port, stage, **flags)
    assert {paths[n][0] for n in names} == {p for p, m in mask.items() if m}
    assert apply_freeze_(port, stage, **flags) == names
    assert [n for n, p in port.named_parameters() if p.requires_grad] == names
    counts = count_params(port)
    jcounts = jfreeze.count_params(params, jfreeze.make_trainable_mask(params, stage, **flags))
    assert counts == jcounts
    if stage == 2:
        assert all(is_lora_param(n) or n.startswith("mlpscore.") for n in names)


def test_decay_groups_match_decay_mask(setup, tmp_path):
    """The predicate on every leaf, and the optimizer's groups of a stage-2
    trainer: weight decay on a parameter exactly where the JAX mask is True."""
    _, params, _, _ = setup
    port = _port(setup)
    mask = _flat(jtrainer.decay_mask(params)["params"])
    paths = jax_paths(port)
    for name, _ in port.named_parameters():
        assert ttrainer.decays(paths[name][0]) == bool(mask[paths[name][0]]), name
    assert not ttrainer.decays(paths["language_model.layers.0.attention_norm.weight"][0])
    assert not ttrainer.decays(paths["mlp1.ln.weight"][0])  # the flax LayerNorm's `scale`
    pt = ttrainer.Trainer(port, ttrainer.TrainConfig(weight_decay=0.1, output_dir=str(tmp_path)), 4)
    by_id = {id(p): n for n, p in port.named_parameters()}
    seen = set()
    for group in pt.optimizer.param_groups:
        for p in group["params"]:
            name = by_id[id(p)]
            seen.add(name)
            assert group["weight_decay"] == (0.1 if mask[paths[name][0]] else 0.0), name
    assert seen == set(pt.trainable)


def test_layer_decay_multipliers_match(setup, monkeypatch):
    _, params, cfg, _ = setup
    port = _port(setup)
    paths = jax_paths(port)
    nv, nl = cfg.vision.num_hidden_layers, cfg.llm.num_hidden_layers
    for rates in ((0.9, 0.8, 0.5), (0.75, None, None)):
        want = _flat(layer_decay_multipliers(params, nv, nl, *rates)["params"])
        got = torch_multipliers(port, nv, nl, *rates)
        for name, _ in port.named_parameters():
            path, layer = paths[name]
            w = want[path] if layer is None else want[path].reshape(-1)[layer]
            assert got[name] == pytest.approx(float(w), rel=1e-6), name
    monkeypatch.setenv("QLLAMA_LR_SCALE", "0.25")
    got = torch_multipliers(port, nv, nl)
    assert got["language_model.norm.weight"] == 0.25 and got["mlpscore.fc1.weight"] == 1.0


# -------------------------------------------------------------- schedule ---


@pytest.mark.parametrize("total,ratio", [(100, 0.03), (10, 0.03), (40, 0.25)])
@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_make_schedule_matches_optax(kind, total, ratio):
    """At steps 0, 1, around the warm-up, mid, the end and past it."""
    kw = dict(learning_rate=3e-4, warmup_ratio=ratio, lr_scheduler_type=kind)
    want = jtrainer.make_schedule(jtrainer.TrainConfig(**kw), total)
    got = ttrainer.make_schedule(ttrainer.TrainConfig(**kw), total)
    warmup = int(total * ratio)
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, total // 2, total - 1,
                        total, total + 5}):
        # optax computes in fp32: relative to the peak rate near the schedule's zero
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-6 * 3e-4), step
    if kind != "constant" and warmup:
        assert got(0) == 0.0


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):  # clipped, and left alone
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = ttrainer.clip_by_global_norm_(got, max_norm)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # a norm just under the bound is not scaled at all (no epsilon)
    g = [torch.tensor([0.6, 0.8]) * 0.999]
    ttrainer.clip_by_global_norm_(g, 1.0)
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.8]) * 0.999, rtol=0, atol=0)


# ------------------------------------------------------------ whole steps ---


def test_two_training_steps_match_the_jax_trainer(setup, tmp_path):
    """Accumulation over 2 micro-batches, clipping active, cosine schedule,
    weight decay and layer decay on: the mean loss and every trainable
    leaf's mean gradient of step 1, then the parameters after 2 steps."""
    model, params, cfg, _ = setup
    kw = dict(
        learning_rate=2e-3, weight_decay=0.1, warmup_ratio=0.0, lr_scheduler_type="cosine",
        gradient_accumulation_steps=2, max_grad_norm=0.05, output_dir=str(tmp_path),
        vit_layer_decay_rate=0.9, llm_layer_decay_rate=0.8, llm_lr_scale=0.5,
    )
    total_steps = 3
    batches = [_batch(cfg, 4, seed) for seed in (2, 3)]

    # JAX: the trainer's own step, and its loss function for the gradients
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
    want_grads = {k: (a + b) / 2 for (k, a), (_, b) in
                  zip(_flat(per_mb[0][1]["params"]).items(), _flat(per_mb[1][1]["params"]).items())}

    port = _port(setup)
    frozen_before = {n: p.detach().clone() for n, p in port.named_parameters()}
    pt = ttrainer.Trainer(port, ttrainer.TrainConfig(**kw), total_steps)
    paths = jax_paths(port)
    mbs = [ttrainer.microbatch(_to_torch(b), 2) for b in batches]

    loss = pt.accumulate_gradients(mbs[0])
    assert float(loss) == pytest.approx(want_loss, rel=GRAD_TOL)
    grads = {n: p.grad.clone() for n, p in pt.trainable_parameters().items()}
    assert {paths[n][0] for n in grads} == set(want_grads)
    for n, g in grads.items():
        want = _jax_leaf(want_grads, n, paths)
        assert np.abs(want).max() > 0, n  # every trainable leaf is live
        _assert_leaf_close(g.numpy(), want, n)
    norm = float(torch.linalg.vector_norm(torch.cat([g.flatten() for g in grads.values()])))
    assert norm > kw["max_grad_norm"]  # the clip is active in step 1

    step = jt.compiled_step()
    with mesh:
        for m in micro:
            jt.state, jloss = step(jt.state, {k: jnp.asarray(v) for k, v in m.items()}, key)
    for m in mbs:
        ploss = pt.train_step(m)
    assert pt.step == int(jt.state.step) == 2
    assert float(ploss) == pytest.approx(float(jloss), rel=GRAD_TOL)
    after = _flat(jax.device_get(jt.state.params)["params"])
    moved = 0.0
    for n, p in port.named_parameters():
        want = _jax_leaf(after, n, paths)
        if n in pt.trainable:
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=PARAM_TOL, err_msg=n)
            moved = max(moved, float((p.detach() - frozen_before[n]).abs().max()))
        else:  # frozen: bit-equal to what was loaded
            assert torch.equal(p.detach(), frozen_before[n]), n
            assert p.grad is None, n
    assert moved > 100 * PARAM_TOL  # the steps did move the parameters


def test_checkpointing_on_and_off_give_the_same_gradients_with_dropout_on(setup):
    """LoRA dropout 0.3 and drop path 0.2: the recompute must draw the masks
    of the first pass, and the generator must end where it ends without
    checkpointing."""
    _, _, cfg, tcfg = setup
    vision = dataclasses.replace(tcfg.vision, drop_path_rate=0.2)
    batch = _to_torch(_batch(cfg, 2, 4))
    results = []
    for ckpt in (False, True, True):
        port = _port(setup, grad_checkpoint=ckpt, lora_dropout=0.3, vision=vision).train()
        apply_freeze_(port, 2)
        gen = torch.Generator().manual_seed(11 if len(results) < 2 else 12)
        set_generator(port, gen)
        out = port(batch["input_ids"], batch["pixel_values"], batch["attention_mask"],
                   mos=batch["mos"])
        out["loss"].backward()
        grads = {n: p.grad.clone() for n, p in port.named_parameters() if p.requires_grad}
        results.append((out["loss"].item(), grads, gen.get_state()))
    (loss_off, g_off, s_off), (loss_on, g_on, s_on), (loss_other, g_other, _) = results
    assert loss_on == loss_off and torch.equal(s_on, s_off)
    for n in g_off:
        torch.testing.assert_close(g_on[n], g_off[n], rtol=1e-6, atol=1e-9, msg=n)
    # the masks matter: another seed gives another loss and gradient
    assert loss_other != loss_off
    n = "vision_model.layers.1.mlp.fc2.lora_b"
    assert not torch.allclose(g_other[n], g_off[n], rtol=1e-3, atol=0)
    # and in eval() the same model is deterministic
    port.eval()
    with torch.no_grad():
        a = port(batch["input_ids"], batch["pixel_values"], batch["attention_mask"])["score"]
        b = port(batch["input_ids"], batch["pixel_values"], batch["attention_mask"])["score"]
    assert torch.equal(a, b)


def test_training_needs_a_generator_when_masks_are_drawn(setup):
    _, _, cfg, _ = setup
    port = _port(setup, lora_dropout=0.1).train()
    batch = _to_torch(_batch(cfg, 1, 5))
    with pytest.raises(RuntimeError, match="generator"):
        port(batch["input_ids"], batch["pixel_values"], batch["attention_mask"])


# ------------------------------------------------------------ checkpoints ---


def test_lora_artifact_round_trips_with_jax_names(setup, tmp_path):
    _, params, _, _ = setup
    port = _port(setup)
    path = str(tmp_path / "out" / LORA_FILE)
    save_lora_weights(path, port)
    from safetensors.torch import load_file

    saved = load_file(path)
    want = {k: v for k, v in _flat(params["params"]).items() if k.split("/")[-1].startswith("lora_")}
    assert set(saved) == set(want)  # the JAX artifact's keys
    for k, v in want.items():
        np.testing.assert_array_equal(saved[k].numpy(), v)  # stacked [L, ...] as in JAX
    other = _port(setup)
    init_lora_(other, seed=3)
    assert not torch.equal(other.vision_model.layers[0].attn.qkv.lora_a,
                           port.vision_model.layers[0].attn.qkv.lora_a)
    load_lora_weights(path, other)
    for (n, a), (_, b) in zip(extract_lora(other).items(), extract_lora(port).items()):
        assert torch.equal(a, b), n
    with pytest.raises(KeyError, match="not present"):
        _, _, _, tcfg = setup
        load_lora_weights(path, TorchAssessor(tcfg.replace(use_backbone_lora=0),
                                              TorchPrecision.fp32()))


def test_trainer_state_save_and_restore(setup, tmp_path):
    """A restored trainer takes the step the saved one takes next, bit for
    bit: parameters, Adam moments, step count and generator state."""
    _, _, cfg, _ = setup
    kw = dict(learning_rate=1e-2, warmup_ratio=0.0, lr_scheduler_type="linear",
              output_dir=str(tmp_path), save_total_limit=2, seed=5)
    batch = ttrainer.microbatch(_to_torch(_batch(cfg, 2, 6)), 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_total_limit=2)
    a = ttrainer.Trainer(_port(setup, lora_dropout=0.2), ttrainer.TrainConfig(**kw), 10,
                         checkpoint_manager=mgr)
    for step in (1, 2, 3):
        a.train_step(batch)
        a.save(step, best=step == 2)
    assert mgr.latest_step() == 3 and mgr._steps() == [2, 3]  # the oldest went
    loss_a = a.train_step(batch)

    b = ttrainer.Trainer(_port(setup, lora_dropout=0.2), ttrainer.TrainConfig(**kw), 10)
    mgr.restore(b)
    assert b.step == 3
    loss_b = b.train_step(batch)
    assert float(loss_a) == float(loss_b)
    for (n, p), (_, q) in zip(a.trainable_parameters().items(), b.trainable_parameters().items()):
        assert torch.equal(p, q), n
    mgr.restore_best(b)
    assert b.step == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(b)


# ---------------------------------------------------------- the CLI's side ---


def test_train_steps_end_to_end_then_merge_and_serve(tmp_path):
    """`build_training_model` -> `train_steps` on uint8 frames and MOS in
    0..100: the loss falls on the repeated batch, the log and the LoRA
    artifact are written, the frozen weights do not move, and the merged
    model served without adapters scores as the trained one does."""
    tcfg = TorchConfig.tiny(stage=2, use_backbone_lora=2, use_llm_lora=2).replace(
        img_context_token_id=CTX)
    model = build_training_model(tcfg, device="cpu", precision=TorchPrecision.fp32(), seed=0)
    served = build_serving_model(tcfg.replace(use_backbone_lora=0, use_llm_lora=0), device="cpu",
                                 precision=TorchPrecision.fp32(), seed=0)
    # one seed: the same base weights with and without adapters
    assert torch.equal(model.vision_model.layers[1].mlp.fc1.weight,
                       served.vision_model.layers[1].mlp.fc1.weight)
    assert all(not m.lora_b.any() and m.lora_a.any() for m in model.modules()
               if isinstance(m, LoRALinear))
    with torch.no_grad():  # an open score head whatever the seed drew
        for i in range(model.mlpscore.num_layers):
            getattr(model.mlpscore, f"fc{i + 1}").weight.abs_()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    rng = np.random.default_rng(7)
    b = _batch(tcfg, 2, 8)
    batch = {
        "input_ids": torch.from_numpy(b["input_ids"]).long(),
        "pixels_u8": torch.from_numpy(rng.integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)),
        "attention_mask": torch.from_numpy(b["attention_mask"]),
        "mos": torch.tensor([35.0, 80.0]),
    }
    cfg = ttrainer.TrainConfig(learning_rate=3e-3, warmup_ratio=0.0, lr_scheduler_type="constant",
                               num_train_epochs=6, output_dir=str(tmp_path), save_steps=0)
    trainer = train_steps(model, [batch], cfg)
    assert trainer.step == 6
    log = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    losses = [r["loss"] for r in log]
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert os.path.exists(tmp_path / LORA_FILE)
    trained = set(trainer.trainable)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]) == (n not in trained), n
    assert all(m.lora_b.any() for m in model.modules() if isinstance(m, LoRALinear))

    ids = batch["input_ids"][:, None]
    mask = batch["attention_mask"][:, None]
    want = score_batch(model.eval(), ids, batch["pixels_u8"], mask)
    merge_lora_(model)
    served.load_state_dict(lora_free_state_dict(model), strict=True)
    got = score_batch(served, ids, batch["pixels_u8"], mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_build_training_model_rejects_what_is_not_ported():
    # stage 1 is ported (tests/test_torch_stage1.py): no score head, the
    # frozen towers built in bf16, the trainable projectors in fp32
    model = build_training_model(TorchConfig.tiny(stage=1), device="cpu")
    assert model.config.stage == 1 and not hasattr(model, "mlpscore")
    assert model.mlp1.fc1.weight.dtype == torch.float32
    assert model.vision_model.layers[0].attn.qkv.weight.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="W8A8"):
        build_training_model(TorchConfig.tiny(stage=2, use_llm_lora=2), device="cpu",
                             precision=TorchPrecision(w8a8=True))
