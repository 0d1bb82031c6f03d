"""The port's stage-2 training CLI (`cli/stage2_train.main`) against the
JAX package's, on the CPU.

Both run the same argv (the tiny model in fp32, `--device cpu` for the
port) over the 8-GIF meta file of tests/test_cli_e2e.py: LoRA rank 2 in both
towers, batch 2, one epoch (4 steps), an eval every 2 steps, a checkpoint
every 2. Both take one JAX tree (`init_or_load_params` / `model_weights`),
every `lora_b` drawn non-zero and the score head non-negative, so that
every trainable leaf has a gradient from the first step; drop path and
LoRA dropout are 0 in both (`config_from_args` patched), so that no random
draw differs. One JAX run per module.

Tolerances (tests/test_torch_train.py): each logged loss within GRAD_TOL =
2e-4 relative; the LoRA artifact's tensors within PARAM_TOL = 1e-5 of JAX's
`lora_weights.msgpack`; the eval CSV's names, answers, outputs, MOS and
levels exactly, `pred_score` within SCORE_TOL = 2e-4. The eval metrics'
keys, `logs/metrics.jsonl`'s keys and the best slot as JAX writes them.
`--resume_from_checkpoint <out>/checkpoints/2` restores the saved trainer
state bit for bit, and the resumed run logs step 3 first; the JAX CLI's
checkpoints restore into the port's trainer bit for bit.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import contextlib
import json

import jax
import numpy as np
import pytest
from flax import serialization

from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.cli import stage2_train as t_stage2
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_tpu.cli import args as j_args
from aigv_assessor_tpu.cli import common as j_common
from aigv_assessor_tpu.cli import stage2_train as j_stage2
from tests._torch_cli_fixtures import (
    assert_holds_tree,
    jit_init,
    open_tree,
    read_best,
    read_csv,
    read_log,
    read_tree_by_name,
    write_gif_meta,
)

GRAD_TOL = 2e-4
PARAM_TOL = 1e-5
SCORE_TOL = 2e-4
LORA = 2
STEPS = 4


def argv(meta, out, *extra):
    return ["--meta_path", meta, "--output_dir", str(out), "--model_scale", "tiny",
            "--max_seq_length", "256", "--bf16", "False", "--num_segments", "4",
            "--dataloader_num_workers", "1", "--group_by_length", "False",
            "--drop_path_rate", "0.0", "--mesh_data", "1", "--mesh_fsdp", "1",
            "--use_backbone_lora", str(LORA), "--use_llm_lora", str(LORA),
            "--do_train", "True", "--num_train_epochs", "1",
            "--per_device_train_batch_size", "2", "--evaluation_strategy", "steps",
            "--eval_steps", "2", "--save_steps", "2", "--save_total_limit", "2",
            "--eval_batch_size", "4", *extra]


def no_dropout(config_from_args):
    return lambda args, stage: config_from_args(args, stage).replace(lora_dropout=0.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (meta, the JAX run's output directory and trainer, the port's
    output directory and trainer, the JAX tree)."""
    d = tmp_path_factory.mktemp("stage2_cli")
    meta = write_gif_meta(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "config_from_args", no_dropout(j_common.config_from_args))
        mp.setattr(j_common, "init_or_load_params", jit_init)
        args = j_args.parse_args("x", argv(meta, d / "unused"))
        _, _, params, _ = j_common.build_model_and_tokenizer(args, 2)
        tree = open_tree(params, lora_b_seed=7)
        mp.setattr(j_common, "init_or_load_params", lambda model, args, config, seed=0: tree)
        jax_trainer = j_stage2.main(argv(meta, d / "jax"))
    with port_weights(tree):
        port_trainer = t_stage2.main(argv(meta, d / "port", "--device", "cpu"))
    return meta, d / "jax", jax_trainer, d / "port", port_trainer, tree


@contextlib.contextmanager
def port_weights(tree):
    """The port's CLI on `tree`, without LoRA dropout."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_common, "config_from_args", no_dropout(t_common.config_from_args))
        mp.setattr(t_common, "model_weights",
                   lambda args, config: state_dict_from_jax(tree, config))
        yield


def test_losses_equal_jax(runs):
    _, jax_out, _, port_out, port_trainer, _ = runs
    want = [r for r in read_log(jax_out) if "loss" in r]
    got = [r for r in read_log(port_out) if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, STEPS + 1))
    assert port_trainer.step == STEPS
    for g, w in zip(got, want):
        assert np.isfinite(g["loss"])
        assert abs(g["loss"] - w["loss"]) <= GRAD_TOL * abs(w["loss"]), (g, w)


def test_lora_artifact_equals_jax(runs):
    from safetensors.torch import load_file

    _, jax_out, _, port_out, _, tree = runs
    with open(jax_out / "lora_weights.msgpack", "rb") as f:
        # JAX keys the full tree's paths, the port those under `params`
        want = {k.removeprefix("params/"): v
                for k, v in serialization.msgpack_restore(f.read()).items()}
    got = load_file(str(port_out / t_stage2.LORA_FILE))
    assert set(got) == set(want) and len(got) > 0
    moved = 0.0
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL, err_msg=key)
        start = tree["params"]
        for part in key.split("/"):
            start = start[part]
        moved = max(moved, float(np.abs(g - np.asarray(start)).max()))
    assert moved > PARAM_TOL  # the steps moved the adapters


def test_eval_csv_equals_jax(runs):
    _, jax_out, _, port_out, _, _ = runs
    got, want = read_csv(port_out / "results.csv"), read_csv(jax_out / "results.csv")
    assert got[0] == want[0] == ["video_name", "answer", "output", "mos", "level", "pred_score"]
    assert len(got) == len(want) == 9
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3] and g[4] == w[4]
        assert float(g[3]) == float(w[3])
        assert abs(float(g[5]) - float(w[5])) <= SCORE_TOL
    assert max(abs(float(g[5])) for g in got[1:]) > 0


def test_eval_metrics_and_best_slot_as_jax(runs):
    """The same eval records (metric keys at steps 2 and 4), the metrics
    file's lines, and the best slot: written at the first eval, then at
    every eval that beats it, holding that eval's step."""
    _, jax_out, _, port_out, _, _ = runs
    got = [r for r in read_log(port_out) if "loss" not in r]
    want = [r for r in read_log(jax_out) if "loss" not in r]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [2, 4]
    for g, w in zip(got, want):
        assert abs(g["eval_SRCC_score"] - w["eval_SRCC_score"]) <= 1e-6

    def keys(out):
        return [line.split(": ")[0] for line in open(out / "metrics.txt")]
    assert keys(port_out) == keys(jax_out)
    best_step = got[0]["step"]
    if got[1]["eval_SRCC_score"] > got[0]["eval_SRCC_score"]:
        best_step = got[1]["step"]
    assert read_best(port_out / "checkpoints")["step"] == best_step
    assert (jax_out / "checkpoints" / "best" / "state").is_dir()
    assert sorted(p.name for p in (port_out / "checkpoints").iterdir()) == sorted(
        p.name for p in (jax_out / "checkpoints").iterdir()) == ["2", "4", "best"]


def test_metrics_jsonl_has_jax_keys(runs):
    _, jax_out, _, port_out, _, _ = runs

    def keys(out):
        return [sorted(json.loads(line)) for line in open(out / "logs" / "metrics.jsonl")]
    assert keys(port_out) == keys(jax_out)
    assert len(keys(port_out)) == STEPS + 2


def test_resume_restores_the_saved_state(runs, tmp_path):
    """`--do_train False` after the restore: the trainer holds step 2's
    trainable tensors, Adam's moments and step, bit for bit, and evaluates."""
    meta, _, _, port_out, _, tree = runs
    slot = port_out / "checkpoints" / "2"
    with port_weights(tree):
        trainer = t_stage2.main(argv(meta, tmp_path, "--device", "cpu", "--do_train", "False",
                                     "--resume_from_checkpoint", str(slot)))
    assert trainer.step == 2
    assert_holds_tree(trainer, slot / "default")
    assert [r["step"] for r in read_log(tmp_path)] == [0]  # the one eval


def test_resume_from_the_jax_checkpoint(runs, tmp_path):
    """The JAX CLI's newest checkpoint (step 4) restores into the port's
    stage-2 trainer bit for bit, adapters, score head, moments and the
    frozen towers alike; and JAX's `CheckpointManager` restores the port
    CLI's into the JAX trainer's state, leaf for leaf (JAX's stage-2 CLI
    never resumes, its manager can)."""
    from aigv_assessor_tpu.train.checkpoint import CheckpointManager as JaxManager

    meta, jax_out, jax_trainer, port_out, _, tree = runs
    with port_weights(tree):
        trainer = t_stage2.main(argv(meta, tmp_path, "--device", "cpu", "--do_train", "False",
                                     "--resume_from_checkpoint", str(jax_out / "checkpoints")))
    assert trainer.step == STEPS
    assert_holds_tree(trainer, jax_out / "checkpoints" / str(STEPS) / "default")
    jm = JaxManager(str(port_out / "checkpoints"))
    restored = jax.device_get(jm.restore(jax_trainer.state))
    jm.close()
    got = read_tree_by_name(port_out / "checkpoints" / str(STEPS) / "default")
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(flat) == len(got)
    for path, x in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in path)
        assert np.array_equal(np.asarray(x), got[name].numpy()), name


def test_resume_continues_at_step_3(runs, tmp_path):
    """The resumed run takes the schedule from epoch 0, as JAX's does: steps
    3 to 6 over the epoch's four batches."""
    meta, _, _, port_out, _, tree = runs
    with port_weights(tree):
        trainer = t_stage2.main(argv(meta, tmp_path, "--device", "cpu", "--evaluation_strategy",
                                     "no", "--resume_from_checkpoint",
                                     str(port_out / "checkpoints" / "2")))
    losses = [r for r in read_log(tmp_path) if "loss" in r]
    assert [r["step"] for r in losses] == [3, 4, 5, 6]
    assert trainer.step == 6 and all(np.isfinite(r["loss"]) for r in losses)
