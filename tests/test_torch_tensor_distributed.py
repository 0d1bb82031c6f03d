"""The port with the `tensor` mesh axis on four ranks (torch.distributed over
gloo, on the CPU) against the one-process port over the same global batch,
and the stage-1 CLI at (data 1, fsdp 2, tensor 2) against JAX's CLI on four
virtual devices.

One pool of four rank processes (`tests/_torch_dist_worker.py`) runs every
case once per module (`tests/_torch_dist_cases.py`); the test process runs
the one-process references (no process group) and the JAX CLI. The mesh is
(data, fsdp, tensor) with `tensor` innermost: the ranks of one tensor group
hold the same rows. On the tiny model (ViT 4 heads, decoder 4 q / 2 kv
heads) tensor 2 splits both towers; tensor 4 splits the ViT (one head a
rank) and leaves the decoder whole, its 2 kv heads not dividing.

- training at (1, 1, 4), (1, 2, 2) and (2, 1, 2): stage 2 (adapters on both
  towers and the score head) and stage 1 (the projectors, two
  micro-batches, unequal label tokens per data rank): per-step losses
  within GRAD_TOL = 2e-4 relative, the trainable weights after two steps
  (gathered into the unsplit layout) within PARAM_TOL = 1e-5;
- a checkpoint saved at (1, 2, 2) resumed at world 1, and one saved at world
  1 resumed at (1, 2, 2): the next step's loss within GRAD_TOL;
- `shard_for_inference` at (1, 1, 4) and (2, 1, 2): `score_perspectives`
  with and without the shared prefix within SCORE_TOL = 1e-5 relative,
  greedy `generate` tokens identical, and every rank of a tensor group
  holding bit-equal scores and tokens;
- the stage-1 CLI main with `--mesh_data 1 --mesh_fsdp 2 --mesh_tensor 2`
  against JAX's CLI with the same flags: the logged losses within GRAD_TOL.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from aigv_assessor_torch.models.loading import jax_leaves, save_jax_params
from tests import _torch_dist_cases as cases
from tests._torch_cli_fixtures import (
    jit_init,
    open_tree,
    read_log,
    read_tree_by_name,
    write_gif_meta,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GRAD_TOL = 2e-4
PARAM_TOL = 1e-5
SCORE_TOL = 1e-5
SPAWN_TIMEOUT_S = 600
LAYOUTS = {"t4": (1, 1, 4), "f2t2": (1, 2, 2), "d2t2": (2, 1, 2)}
TRAIN = {f"s{stage}_{k}": (stage, lay, 1 if stage == 2 else 2)
         for stage in (2, 1) for k, lay in LAYOUTS.items()}
INFERENCE = {"inf_t4": LAYOUTS["t4"], "inf_d2t2": LAYOUTS["d2t2"]}
CKPT_LAYOUT = LAYOUTS["f2t2"]
CLI_MESH = ("--mesh_data", "1", "--mesh_fsdp", "2", "--mesh_tensor", "2")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_argv(meta, out, *extra):
    return ["--meta_path", meta, "--output_dir", str(out), "--model_scale", "tiny",
            "--max_seq_length", "256", "--bf16", "False", "--num_segments", "4",
            "--dataloader_num_workers", "1", "--group_by_length", "False",
            "--drop_path_rate", "0.0", *CLI_MESH,
            "--do_train", "True", "--num_train_epochs", "1",
            "--per_device_train_batch_size", "1", "--evaluation_strategy", "no", *extra]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Runs every 4-rank case in one pool -> {case: result or None}, the
    work directory, the JAX tree of the CLI case and its meta file."""
    from aigv_assessor_tpu.cli import args as j_args
    from aigv_assessor_tpu.cli import common as j_common

    work = tmp_path_factory.mktemp("tensor")
    # a checkpoint written at world 1, for the ranks to resume
    cases.save_after_one_step(str(work / "ckpt_w1"), None, out_dir=str(work / "ref_w1"))
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
    plan.update({name: {"kind": "inference", "eos": -1, "layout": list(lay)}
                 for name, lay in INFERENCE.items()})
    plan["save_t2"] = {"kind": "save", "layout": list(CKPT_LAYOUT), "ckpt": str(work / "ckpt_t2")}
    plan["resume_w1"] = {"kind": "resume", "layout": list(CKPT_LAYOUT),
                         "ckpt": str(work / "ckpt_w1")}
    plan["cli_stage1"] = {"kind": "cli_stage1", "argv": cli_argv(
        meta, work / "port_cli", "--device", "cpu", "--model_name_or_path",
        str(work / "tree"))}
    (work / "plan.json").write_text(json.dumps(plan))

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(key, None)
    worker = os.path.join(REPO, "tests", "_torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD), str(port), str(work)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
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
    """-> ref(stage, accum, data ranks): the one-process port's run over the
    same global micro-batches, made once per module."""
    done = {}

    def ref(stage, accum, layout_world):
        key = (stage, accum, layout_world)
        if key not in done:
            assert not dist.is_initialized()
            out = tmp_path_factory.mktemp(f"ref_s{stage}_a{accum}_w{layout_world}")
            done[key] = cases.train_case(stage, None, accum, out_dir=str(out),
                                         layout_world=layout_world)
        return done[key]
    return ref


@pytest.mark.parametrize("name", list(TRAIN))
def test_tensor_layouts_train_as_one_process(pool, reference, name):
    stage, layout, accum = TRAIN[name]
    got = _result(pool, name)
    want = reference(stage, accum, layout[0] * layout[1])
    assert len(got["losses"]) == len(want["losses"]) == cases.STEPS
    for g, w in zip(got["losses"], want["losses"]):
        assert np.isfinite(g) and abs(g - w) <= GRAD_TOL * abs(w), (got["losses"],
                                                                   want["losses"])
    start = cases.build(stage).state_dict()
    assert set(got["weights"]) == set(want["weights"]) and want["weights"]
    moved = 0.0
    for n, w in want["weights"].items():
        assert got["weights"][n].shape == w.shape, n  # the unsplit layout
        np.testing.assert_allclose(got["weights"][n].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=n)
        moved = max(moved, float((w - start[n]).abs().max()))
    assert moved > 10 * PARAM_TOL  # the steps moved the weights


@pytest.mark.parametrize("name", list(INFERENCE))
def test_split_scores_and_tokens_match_one_process(pool, name):
    got = _result(pool, name)
    want = cases.inference_case(shard=False)
    tensor = INFERENCE[name][2]
    for key in ("scores", "scores_prefix", "tokens"):
        rows, every = got[key]
        # the ranks of each tensor group hold the same bits
        for g in range(WORLD // tensor):
            for t in range(1, tensor):
                assert torch.equal(every[g * tensor + t], every[g * tensor]), (key, g, t)
        if key == "tokens":
            assert rows.shape == (cases.GLOBAL_B, cases.GEN_TOKENS)
            assert torch.equal(rows, want[key])
        else:
            assert rows.shape == want[key].shape == (cases.GLOBAL_B, cases.P)
            np.testing.assert_allclose(rows.numpy(), want[key].numpy(), rtol=SCORE_TOL,
                                       atol=0, err_msg=key)
    assert want["scores"].abs().min() > 0  # open heads: the scores carry the readout


def test_checkpoint_tensor2_resumes_at_world1(pool, reference, tmp_path):
    went_on = _result(pool, "save_t2")["next_loss"]
    step, loss = cases.resume_and_step(str(pool["work"] / "ckpt_t2"), None,
                                       out_dir=str(tmp_path))
    assert step == 1
    want = reference(2, 1, 2)["losses"][1]
    assert abs(loss - went_on) <= GRAD_TOL * abs(went_on)
    assert abs(loss - want) <= GRAD_TOL * abs(want)
    # the saved state is in the unsplit layout: a one-card model's JAX tree
    state = read_tree_by_name(pool["work"] / "ckpt_t2" / "1" / "default")
    model = cases.build(2)
    shapes = {"params.params." + path.replace("/", "."): tuple(t.shape)
              for path, t in jax_leaves(model, model.state_dict()).items()}
    assert {n: tuple(t.shape) for n, t in state.items() if n.startswith("params.")} == shapes


def test_checkpoint_world1_resumes_at_tensor2(pool, reference):
    got = _result(pool, "resume_w1")
    assert got["step"] == 1
    want = reference(2, 1, 2)["losses"][1]
    assert abs(got["next_loss"] - want) <= GRAD_TOL * abs(want)


def test_stage1_cli_tensor2_matches_jax(pool):
    """`cli/stage1_train.main` on four ranks at (data 1, fsdp 2, tensor 2)
    against JAX's stage-1 CLI on four of its eight virtual devices, same
    flags: per-step losses."""
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
