"""The port on two ranks (torch.distributed over gloo, on the CPU) against
the one-process port over the same global batch, and the stage-1 CLI at
world 2 against JAX's CLI on two virtual devices.

One pool of two rank processes (`tests/_torch_dist_worker.py`) runs every
2-rank case once per module (`tests/_torch_dist_cases.py`); the test process
runs the one-process references (no process group) and the JAX CLI. Each
rank holds its contiguous rows of the global batch, as the loaders shard
them.

- training, at (data=2, fsdp=1) and (data=1, fsdp=2): stage 2 (LoRA and the
  score head on the L1, equal local batches) and stage 1 (the projectors on
  the cross-entropy, two micro-batches, the ranks holding 5 and 20 label
  tokens): per-step losses within GRAD_TOL = 2e-4 relative and the trainable
  weights after two steps within PARAM_TOL = 1e-5, the tolerances of
  tests/test_torch_train.py;
- a checkpoint saved at world 2 resumed at world 1 and one saved at world 1
  resumed at world 2: the next step's loss within GRAD_TOL of the run that
  went on;
- `shard_for_inference` at world 2: `score_perspectives` with and without the
  shared prefix within SCORE_TOL = 1e-5 relative, greedy `generate` tokens
  identical;
- the stage-1 CLI main at world 2 with `--mesh_data 1 --mesh_fsdp 2
  --per_device_train_batch_size 1` against JAX's CLI with the same flags:
  the logged losses within tests/test_torch_train_cli_stage1.py's GRAD_TOL.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aigv_assessor_torch.models.loading import jax_leaves, save_jax_params
from aigv_assessor_torch.parallel.sharding import is_sharded
from tests import _torch_dist_cases as cases
from tests._torch_cli_fixtures import (
    jit_init,
    open_tree,
    read_log,
    read_tree_by_name,
    write_gif_meta,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 2e-4
PARAM_TOL = 1e-5
SCORE_TOL = 1e-5
SPAWN_TIMEOUT_S = 600
TRAIN = {  # case -> (stage, layout, micro-batches)
    "s2_data2": (2, (2, 1), 1),
    "s2_fsdp2": (2, (1, 2), 1),
    "s1_data2": (1, (2, 1), 2),
    "s1_fsdp2": (1, (1, 2), 2),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_argv(meta, out, *extra):
    return ["--meta_path", meta, "--output_dir", str(out), "--model_scale", "tiny",
            "--max_seq_length", "256", "--bf16", "False", "--num_segments", "4",
            "--dataloader_num_workers", "1", "--group_by_length", "False",
            "--drop_path_rate", "0.0", "--mesh_data", "1", "--mesh_fsdp", "2",
            "--do_train", "True", "--num_train_epochs", "1",
            "--per_device_train_batch_size", "1", "--evaluation_strategy", "no", *extra]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Runs every 2-rank case in one pool -> {case: result or None}, the
    work directory, the JAX tree of the CLI case and its meta file."""
    from aigv_assessor_tpu.cli import args as j_args
    from aigv_assessor_tpu.cli import common as j_common

    work = tmp_path_factory.mktemp("dist")
    # a checkpoint written at world 1, for the ranks to resume
    cases.save_after_one_step(str(work / "ckpt_w1"), None, out_dir=str(work / "ref_w1"))
    # the CLI case's weights: one JAX tree, as the port reads a JAX params file
    meta = write_gif_meta(work)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "init_or_load_params", jit_init)
        _, _, params, _ = j_common.build_model_and_tokenizer(
            j_args.parse_args("x", cli_argv(meta, work / "unused")), 1)
    tree = open_tree(params)
    (work / "tree").mkdir()
    save_jax_params(str(work / "tree" / "params.safetensors"), tree)

    plan = {name: {"kind": "train", "stage": s, "layout": list(lay), "accum": a}
            for name, (s, lay, a) in TRAIN.items()}
    plan["inference"] = {"kind": "inference", "eos": -1}
    plan["save_w2"] = {"kind": "save", "layout": [1, 2], "ckpt": str(work / "ckpt_w2")}
    plan["resume_w1"] = {"kind": "resume", "layout": [1, 2], "ckpt": str(work / "ckpt_w1")}
    plan["cli_stage1"] = {"kind": "cli_stage1", "argv": cli_argv(
        meta, work / "port_cli", "--device", "cpu", "--model_name_or_path",
        str(work / "tree"))}
    (work / "plan.json").write_text(json.dumps(plan))

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(key, None)
    worker = os.path.join(REPO, "tests", "_torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", str(port), str(work)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    results = {}
    for name in plan:
        path = work / f"{name}.pt"
        results[name] = torch.load(path, weights_only=False) if path.exists() else None
    return {"results": results, "work": work, "logs": logs, "tree": tree, "meta": meta}


def _result(pool, name):
    got = pool["results"][name]
    if got is None:
        errs = sorted(pool["work"].glob(f"{name}.err.r*"))
        detail = errs[0].read_text() if errs else pool["logs"][0][-4000:]
        pytest.fail(f"case {name} did not finish on the ranks:\n{detail}")
    return got


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """-> ref(stage, accum): the one-process port's run over the same global
    (micro-)batches, made once per module."""
    done = {}

    def ref(stage, accum):
        if (stage, accum) not in done:
            assert not dist.is_initialized()
            out = tmp_path_factory.mktemp(f"ref_s{stage}_a{accum}")
            done[stage, accum] = cases.train_case(stage, None, accum, out_dir=str(out))
        return done[stage, accum]
    return ref


@pytest.mark.parametrize("name", list(TRAIN))
def test_two_ranks_train_as_one_process(pool, reference, name):
    stage, _, accum = TRAIN[name]
    got, want = _result(pool, name), reference(stage, accum)
    assert len(got["losses"]) == len(want["losses"]) == cases.STEPS
    for g, w in zip(got["losses"], want["losses"]):
        assert np.isfinite(g) and abs(g - w) <= GRAD_TOL * abs(w), (got["losses"],
                                                                   want["losses"])
    start = cases.build(stage).state_dict()
    assert set(got["weights"]) == set(want["weights"]) and want["weights"]
    moved = 0.0
    for n, w in want["weights"].items():
        np.testing.assert_allclose(got["weights"][n].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=n)
        moved = max(moved, float((w - start[n]).abs().max()))
    assert moved > 10 * PARAM_TOL  # the steps moved the weights


def test_stage1_ranks_hold_unequal_label_tokens():
    """The stage-1 case's premise: the two ranks' rows hold 5 and 20 label
    tokens, so a mean of per-rank means is not the global loss."""
    batch = cases.global_batch(cases.config(1), 0, 1)
    per_row = (batch["labels"][:, 1:] != -100).sum(1).tolist()
    assert [sum(per_row[:2]), sum(per_row[2:])] == [5, 20]


def test_sharded_scores_and_tokens_match_one_process(pool):
    got = _result(pool, "inference")
    want = cases.inference_case(shard=False)
    for key in ("scores", "scores_prefix"):
        assert got[key].shape == want[key].shape == (cases.GLOBAL_B, cases.P)
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=SCORE_TOL,
                                   atol=0, err_msg=key)
    assert want["scores"].abs().min() > 0  # open heads: the scores carry the readout
    assert torch.equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (cases.GLOBAL_B, cases.GEN_TOKENS)


def test_checkpoint_world2_resumes_at_world1(pool, reference, tmp_path):
    went_on = _result(pool, "save_w2")["next_loss"]
    step, loss = cases.resume_and_step(str(pool["work"] / "ckpt_w2"), None,
                                       out_dir=str(tmp_path))
    assert step == 1
    want = reference(2, 1)["losses"][1]
    assert abs(loss - went_on) <= GRAD_TOL * abs(went_on)
    assert abs(loss - want) <= GRAD_TOL * abs(want)


def test_checkpoint_world2_is_orbax_s(pool):
    """The checkpoint the two ranks wrote (the primary alone, from the
    gathered tensors) is JAX's orbax layout: orbax restores it, leaf for
    leaf as the port reads it, and it holds the whole stage-2 tree."""
    import orbax.checkpoint as ocp

    item = pool["work"] / "ckpt_w2" / "1" / "default"
    got = read_tree_by_name(item)
    restored = ocp.StandardCheckpointer().restore(str(item))
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert set(flat) == set(got)
    for name, x in flat.items():
        assert np.array_equal(np.asarray(x), got[name].numpy()), name
    model = cases.build(2)
    shapes = {"params.params." + path.replace("/", "."): tuple(t.shape)
              for path, t in jax_leaves(model, model.state_dict()).items()}
    assert {n: tuple(t.shape) for n, t in got.items() if n.startswith("params.")} == shapes
    assert int(got["step"]) == 1


def test_checkpoint_world1_resumes_at_world2(pool, reference):
    got = _result(pool, "resume_w1")
    assert got["step"] == 1
    want = reference(2, 1)["losses"][1]
    assert abs(got["next_loss"] - want) <= GRAD_TOL * abs(want)


def test_one_process_trainer_wraps_nothing(tmp_path):
    """Without a process group the trainer builds no mesh and leaves the
    model's parameters plain tensors."""
    assert not dist.is_initialized()
    model = cases.build(2)
    trainer = cases.trainer_for(model, str(tmp_path), 2)
    assert trainer.mesh is None and not is_sharded(model)
    assert all(type(p) is torch.nn.Parameter for p in model.parameters())


def test_stage1_cli_world2_matches_jax(pool):
    """`cli/stage1_train.main` on two ranks against JAX's stage-1 CLI on two
    of its eight virtual devices, same flags: per-step losses."""
    from aigv_assessor_tpu.cli import common as j_common
    from aigv_assessor_tpu.cli import stage1_train as j_stage1

    _result(pool, "cli_stage1")
    tree = pool["tree"]
    jax_out = pool["work"] / "jax_cli"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "init_or_load_params", lambda model, args, config, seed=0: tree)
        j_stage1.main(cli_argv(pool["meta"], jax_out))
    want = [r for r in read_log(jax_out) if "loss" in r]
    got = [r for r in read_log(pool["work"] / "port_cli") if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert np.isfinite(g["loss"]) and abs(g["loss"] - w["loss"]) <= GRAD_TOL * abs(w["loss"])
    assert (pool["work"] / "port_cli" / "checkpoints" / "4" / "default" / "_METADATA").exists()
