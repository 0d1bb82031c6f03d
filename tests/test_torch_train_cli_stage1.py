"""The port's stage-1 training CLI (`cli/stage1_train.main`) against the
JAX package's, on the CPU.

Both run the same argv (the tiny model in fp32, `--device cpu` for the
port) over the 8-GIF meta file of tests/test_cli_e2e.py: batch 4, one epoch
(2 steps) at the shipping learning rate, an eval at step 2, on one JAX tree
(`init_or_load_params` / `model_weights`), drop path 0. Stage 1 trains `mlp1` and `motion_mlp` on
the answer's cross-entropy and keeps the best checkpoint by quality-level
accuracy. Then `--do_train False`: one eval of the untrained tree by both.
One JAX run of each per module. The checkpoints are JAX's layout both
ways: the port resumes from the JAX CLI's, JAX restores the port's.

Tolerances (tests/test_torch_train.py): each logged loss within GRAD_TOL =
2e-4 relative; the trained weights' file (`TRAINABLE_FILE`) within
PARAM_TOL = 1e-5 of the JAX trainer's final parameters; the eval CSV's
rows and the metrics exactly, as tests/test_torch_eval.py holds the
stage-1 eval CLI; the eval records, `logs/metrics.jsonl`'s keys and the
best slot as JAX writes them. With no card and no `--device`, the CLI
raises.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import json

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.cli import stage1_train as t_stage1
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_tpu.cli import args as j_args
from aigv_assessor_tpu.cli import common as j_common
from aigv_assessor_tpu.cli import stage1_train as j_stage1
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
METRIC_TOL = 1e-6
STEPS = 2


def argv(meta, out, *extra):
    return ["--meta_path", meta, "--output_dir", str(out), "--model_scale", "tiny",
            "--max_seq_length", "256", "--bf16", "False", "--num_segments", "4",
            "--dataloader_num_workers", "1", "--group_by_length", "False",
            "--drop_path_rate", "0.0", "--mesh_data", "1", "--mesh_fsdp", "1",
            "--do_train", "True", "--num_train_epochs", "1",
            "--per_device_train_batch_size", "4", "--evaluation_strategy", "steps",
            "--eval_steps", "2", "--eval_batch_size", "4", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> {name: (JAX output directory, port output directory, JAX trainer,
    port trainer)} for 'train' and 'eval' (`--do_train False`), the JAX tree
    under 'tree' and the meta file under 'meta'."""
    d = tmp_path_factory.mktemp("stage1_cli")
    meta = write_gif_meta(d)
    out = {"tree": None, "meta": meta}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "init_or_load_params", jit_init)
        _, _, params, _ = j_common.build_model_and_tokenizer(
            j_args.parse_args("x", argv(meta, d / "unused")), 1)
        tree = out["tree"] = open_tree(params)
        mp.setattr(j_common, "init_or_load_params", lambda model, args, config, seed=0: tree)
        mp.setattr(t_common, "model_weights",
                   lambda args, config: state_dict_from_jax(tree, config))
        for name, extra in (("train", ()), ("eval", ("--do_train", "False"))):
            j_out, t_out = d / f"jax_{name}", d / f"port_{name}"
            jax_trainer = j_stage1.main(argv(meta, j_out, *extra))
            port_trainer = t_stage1.main(argv(meta, t_out, "--device", "cpu", *extra))
            out[name] = (j_out, t_out, jax_trainer, port_trainer)
    return out


def read_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in (line.rstrip("\n").split(": ") for line in f)}


def test_losses_equal_jax(runs):
    jax_out, port_out, _, port_trainer = runs["train"]
    want = [r for r in read_log(jax_out) if "loss" in r]
    got = [r for r in read_log(port_out) if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, STEPS + 1))
    assert port_trainer.step == STEPS
    for g, w in zip(got, want):
        assert np.isfinite(g["loss"])
        assert abs(g["loss"] - w["loss"]) <= GRAD_TOL * abs(w["loss"]), (g, w)


def test_trained_weights_equal_jax(runs):
    """The trained projectors as the port writes them (JAX paths and layout)
    against the JAX trainer's final parameters, and nothing else
    trainable."""
    from safetensors.torch import load_file

    jax_out, port_out, jax_trainer, port_trainer = runs["train"]
    got = load_file(str(port_out / t_stage1.TRAINABLE_FILE))
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax_trainer.state.params["params"]).items()}
    assert got and {k.split("/")[0] for k in got} == {"mlp1", "motion_mlp"}
    start = {"/".join(k): np.asarray(v) for k, v in
             traverse_util.flatten_dict(runs["tree"]["params"]).items()}
    moved = 0.0
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), flat[key], rtol=0, atol=PARAM_TOL, err_msg=key)
        moved = max(moved, float(np.abs(g.numpy() - start[key]).max()))
    assert moved > PARAM_TOL  # the steps moved the projectors
    trainable = set(port_trainer.trainable)
    assert trainable and all(n.startswith(("mlp1.", "motion_mlp.")) for n in trainable)


def test_eval_csv_and_metrics_equal_jax(runs):
    for name in ("train", "eval"):
        jax_out, port_out, _, _ = runs[name]
        got, want = read_csv(port_out / "results.csv"), read_csv(jax_out / "results.csv")
        assert got[0] == want[0] == ["video_name", "answer", "output", "mos", "level"]
        assert len(got) == len(want) == 9
        for g, w in zip(got[1:], want[1:]):
            assert g[:3] == w[:3] and g[4] == w[4], name
            assert float(g[3]) == float(w[3])
        got_m = read_metrics(port_out / "metrics.txt")
        want_m = read_metrics(jax_out / "metrics.txt")
        assert list(got_m) == list(want_m) == ["Accuracy", "SRCC", "PLCC", "KRCC"]
        for k in want_m:
            assert np.isclose(got_m[k], want_m[k], rtol=METRIC_TOL, atol=METRIC_TOL,
                              equal_nan=True), (name, k)


def test_eval_records_and_best_slot_as_jax(runs):
    """The eval record (accuracy first among the keys JAX logs), the best
    slot at the first eval, and the step slots JAX keeps."""
    jax_out, port_out, _, _ = runs["train"]
    got = [r for r in read_log(port_out) if "loss" not in r]
    want = [r for r in read_log(jax_out) if "loss" not in r]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [2] and "eval_accuracy" in got[0]
    assert np.isclose(got[0]["eval_accuracy"], want[0]["eval_accuracy"])
    best = read_best(port_out / "checkpoints")
    assert best["step"] == 2 and best["best_metric"] == got[0]["eval_accuracy"]
    assert (jax_out / "checkpoints" / "best" / "state").is_dir()
    assert sorted(p.name for p in (port_out / "checkpoints").iterdir()) == sorted(
        p.name for p in (jax_out / "checkpoints").iterdir()) == ["2", "best"]


def test_resume_from_either_package(runs, tmp_path):
    """`--resume_from_checkpoint` on the JAX CLI's checkpoints (`--do_train
    False`): the port's trainer holds JAX's saved tree bit for bit, the
    frozen towers too; and the port's own checkpoint restores through JAX's
    `CheckpointManager` into the JAX trainer's state."""
    meta = runs["meta"]
    jax_out, port_out, jax_trainer, _ = runs["train"]
    saved = jax_out / "checkpoints"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_common, "model_weights", lambda args, config: state_dict_from_jax(
            runs["tree"], config))
        trainer = t_stage1.main(argv(meta, tmp_path, "--device", "cpu", "--do_train", "False",
                                     "--resume_from_checkpoint", str(saved)))
    assert trainer.step == STEPS
    assert_holds_tree(trainer, saved / str(STEPS) / "default")
    from aigv_assessor_tpu.train.checkpoint import CheckpointManager as JaxManager

    jm = JaxManager(str(port_out / "checkpoints"))
    restored = jm.restore(jax_trainer.state)
    jm.close()
    got = read_tree_by_name(port_out / "checkpoints" / str(STEPS) / "default")
    for path, x in jax.tree_util.tree_flatten_with_path(jax.device_get(restored))[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in path)
        assert np.array_equal(np.asarray(x), got[name].numpy()), name


def test_metrics_jsonl_has_jax_keys(runs):
    for name in ("train", "eval"):
        jax_out, port_out, _, _ = runs[name]

        def keys(out):
            return [sorted(json.loads(line)) for line in open(out / "logs" / "metrics.jsonl")]
        assert keys(port_out) == keys(jax_out), name
    assert len(keys(port_out)) == 1  # --do_train False: the one eval


def test_do_train_false_evaluates_once_and_trains_nothing(runs):
    jax_out, port_out, _, port_trainer = runs["eval"]
    steps = [r["step"] for r in read_log(port_out)]
    assert steps == [r["step"] for r in read_log(jax_out)] == [0]
    assert port_trainer.step == 0
    assert not (port_out / t_stage1.TRAINABLE_FILE).exists()


def test_default_device_without_a_card_raises(runs, tmp_path):
    """`--device` defaults to cuda: with no card the CLI raises, it does not
    move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card check does not apply")
    args = argv(runs["meta"], tmp_path)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        t_stage1.main(args)
    assert not (tmp_path / "train_log.jsonl").exists()
