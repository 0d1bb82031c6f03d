"""The port's eval path against the JAX package, on the CPU.

Fixture: four GIFs and one mp4 (PIL, cv2) under two perspective
annotations over the same videos (answers with quality words, mos from a
seed), the meta JSONs that point at them, and a meta with two entries.

- `data/{dataset, collator, sampler, loader, storage}.py`, the rest of
  `data/preprocess.py`, `QUALITY_LEVELS` and the CLI parser against the JAX
  copies: the same samples (ids, labels, masks, pixels, exactly), text and
  pixel items, batches through the threaded loader, sampler orders and
  shards; `preprocess_plain` and the masker choice per template.
- `word_to_level`, `decode_answer_span`, `correlation_metrics`,
  `save_and_evaluate` and `save_perspective_results`: the same values, and
  files byte-equal to the JAX functions' on the same rows.
- The eval CLIs end to end on the tiny config in fp32, the JAX CLI and the
  port's on the same weights: JAX's `init_or_load_params` and the port's
  `model_weights` both hand out one JAX tree (the port's through
  `state_dict_from_jax`), at stage 2 a score head made non-negative, so
  that the readout reaches the score, with rank-2 adapters whose `lora_b`
  is drawn non-zero (live in both) and without. Stage 1: the same
  `output` and `level` per row, metrics within 1e-6. Stage 2, solo and
  fused (`--fused_meta_paths`, on the shared prefix): `pred_score` within
  SCORE_TOL of JAX, fused within SCORE_TOL of solo; a prefix one token too
  long fails that bound. `--eval_w8a8` with the adapters: the fused eval
  within W8A8_SCORE_TOL of JAX's, which the build that merges the adapters
  before quantizing misses. `--vision_path` grafts a tower: the run's own
  seeded tower gives its scores exactly, another seed's tower others.

One JAX run per CLI mode, shared through module-scoped fixtures.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import csv
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from aigv_assessor_torch.cli import args as t_args
from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.cli import stage1_eval as t_stage1
from aigv_assessor_torch.cli import stage2_eval as t_stage2
from aigv_assessor_torch.core import config as tcfg
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.data import collator as t_col
from aigv_assessor_torch.data import constants as t_const
from aigv_assessor_torch.data import dataset as t_ds
from aigv_assessor_torch.data import loader as t_loader
from aigv_assessor_torch.data import preprocess as t_pre
from aigv_assessor_torch.data import sampler as t_smp
from aigv_assessor_torch.data import storage as t_sto
from aigv_assessor_torch.data import tokenizer as t_tok
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import jax_tree, save_jax_params, state_dict_from_jax
from aigv_assessor_torch.models.lora import lora_free_state_dict, merge_lora_
from aigv_assessor_torch.train import evaluate as t_ev
from aigv_assessor_tpu.cli import args as j_args
from aigv_assessor_tpu.cli import common as j_common
from aigv_assessor_tpu.cli import stage1_eval as j_stage1
from aigv_assessor_tpu.cli import stage2_eval as j_stage2
from aigv_assessor_tpu.core import config as jcfg
from aigv_assessor_tpu.data import collator as j_col
from aigv_assessor_tpu.data import constants as j_const
from aigv_assessor_tpu.data import dataset as j_ds
from aigv_assessor_tpu.data import loader as j_loader
from aigv_assessor_tpu.data import preprocess as j_pre
from aigv_assessor_tpu.data import sampler as j_smp
from aigv_assessor_tpu.data import storage as j_sto
from aigv_assessor_tpu.data import tokenizer as j_tok
from aigv_assessor_tpu.train import evaluate as j_ev
from tests._torch_cli_fixtures import jit_init

# fp32, the port's CLIs against JAX's on one tree: measured 1.3e-7 to 2.0e-7
# with live rank-2 adapters (merged, as the port built them before, they cost
# up to 2e-4, the fp32 slice bound of tests/test_torch_models.py)
SCORE_TOL = 1e-5
# the fused eval under --eval_w8a8 against JAX's: int8 values at rounding
# ties land on either side in XLA and in PyTorch. Measured: 1.35e-3 without
# adapters, 2.11e-3 with live rank-2 adapters, and 9.96e-3 for the build that
# merged the adapters before quantizing
W8A8_SCORE_TOL = 5e-3
METRIC_TOL = 1e-6
N_VIDEOS, T, MAX_LEN = 5, 4, 256
WORDS = ["excellent", "good", "fair", "poor", "bad"]
QUESTIONS = ["How would you rate the static quality of this video?",
             "How would you rate the temporal smoothness of this video?"]
ANSWERS = ["The static quality of the video is {}.", "The temporal smoothness of the video is {}."]


@pytest.fixture(scope="module")
def metas(tmp_path_factory):
    """-> (meta of perspective 1, meta of perspective 2, a two-entry meta)."""
    import cv2

    root = tmp_path_factory.mktemp("eval_data")
    (root / "videos").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i in range(N_VIDEOS - 1):
        frames = [Image.fromarray(rng.integers(0, 256, (48, 64, 3), np.uint8))
                  for _ in range(6 + i)]
        frames[0].save(root / "videos" / f"clip{i}.gif", save_all=True,
                       append_images=frames[1:], duration=100)
        names.append(f"videos/clip{i}.gif")
    w = cv2.VideoWriter(str(root / "videos" / "movie.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                        10, (64, 48))
    for _ in range(12):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    names.append("videos/movie.mp4")
    paths = []
    for p in range(2):
        rows = []
        for i, name in enumerate(names):
            mos = float(rng.uniform(10, 90))
            rows.append({"video": name, "id": f"{name}->{mos:.3f}",
                         **({"mos": mos} if i % 2 == 0 else {}),  # else parsed from the id
                         "conversations": [
                             {"from": "human", "value": QUESTIONS[p] + " "},
                             {"from": "gpt", "value": ANSWERS[p].format(WORDS[(i + p) % 5])}]})
        ann = root / f"test_p{p}.jsonl"
        ann.write_text("".join(json.dumps(r) + "\n" for r in rows))
        meta = root / f"meta_p{p}.json"
        meta.write_text(json.dumps({f"persp{p}": {
            "root": str(root), "annotation": str(ann), "repeat_time": 1,
            "data_augment": False}}))
        paths.append(str(meta))
    multi = root / "meta_multi.json"
    multi.write_text(json.dumps({
        "a": {"root": str(root), "annotation": str(root / "test_p0.jsonl"), "repeat_time": 2},
        "b": {"root": str(root), "annotation_test": str(root / "test_p1.jsonl")}}))
    return paths[0], paths[1], str(multi)


@pytest.fixture(scope="module")
def tokenizers():
    return (t_tok.build_test_tokenizer(model_max_length=MAX_LEN),
            j_tok.build_test_tokenizer(model_max_length=MAX_LEN))


def configs(stage: int, tok):
    ctx = int(tok.img_context_token_id)
    return (tcfg.AssessorConfig.tiny(stage=stage).replace(img_context_token_id=ctx),
            jcfg.AssessorConfig.tiny(stage=stage).replace(img_context_token_id=ctx))


def assert_samples_equal(a, b):
    for field in ("input_ids", "labels", "attention_mask", "pixel_values", "image_flags"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.video_name, a.answer, a.mos, a.length) == (b.video_name, b.answer, b.mos, b.length)


# --------------------------------------------------------------- host side --


def test_constants_parser_and_storage_equal_jax(tmp_path):
    assert t_const.QUALITY_LEVELS == j_const.QUALITY_LEVELS
    t_parser, j_parser = t_args.build_parser("x"), j_args.build_parser("x")
    t_actions = {a.dest: a for a in t_parser._actions}
    for a in j_parser._actions:
        b = t_actions.pop(a.dest)
        assert (b.option_strings, b.default, b.nargs, b.choices, b.required) == (
            a.option_strings, a.default, a.nargs, a.choices, a.required), a.dest
        assert getattr(b.type, "__name__", None) == getattr(a.type, "__name__", None), a.dest
    assert set(t_actions) == {"device"} and t_actions["device"].default == "cuda"
    argv = ["--meta_path", "m.json", "--use_llm_lora", "8", "--bf16", "False"]
    assert vars(t_args.parse_args("x", argv + ["--device", "cpu"])) == {
        **vars(j_args.parse_args("x", argv)), "device": "cpu"}
    t_args.parse_args("x", argv + ["--mesh_data", "1"])
    # the data / fsdp / tensor axes lay out a process group's ranks
    # (cli/common.mesh_from_args: more than one process needs a group)
    for flag in ("--mesh_data", "--mesh_fsdp", "--mesh_tensor"):
        args = t_args.parse_args("x", argv + [flag, "2"])
        assert getattr(args, flag[2:]) == 2
        assert vars(args) == {**vars(j_args.parse_args("x", argv + [flag, "2"])),
                              "device": args.device}
        with pytest.raises(ValueError, match="only 1 available"):
            t_common.mesh_from_args(args)
    # storage: a registered scheme, a file, an unregistered remote path
    img = tmp_path / "x.png"
    Image.fromarray(np.full((4, 5, 3), 7, np.uint8)).save(img)
    t_sto.register_loader("mem://", lambda p: img.read_bytes())
    try:
        assert t_sto.open_bytes("mem://a") == j_sto.open_bytes(str(img))
        np.testing.assert_array_equal(np.asarray(t_sto.open_image("mem://a")),
                                      np.asarray(j_sto.open_image(str(img))))
    finally:
        t_sto._LOADERS.pop("mem://")
    assert t_sto.is_remote("s3://b/k") and not t_sto.is_remote(str(img))
    with pytest.raises(IOError, match="no storage loader"):
        t_sto.open_bytes("s3://bucket/key")


@pytest.mark.parametrize("template", ["internvl_zh", "internlm2-chat", "Hermes-2", "phi3-chat"])
def test_preprocess_function_equals_jax(tokenizers, template):
    t_tk, j_tk = tokenizers
    fn_t, fn_j = t_pre.get_preprocess_function(template), j_pre.get_preprocess_function(template)
    assert fn_t.__name__ == fn_j.__name__
    conv = [{"from": "human", "value": "<image>\n" + QUESTIONS[0]},
            {"from": "gpt", "value": ANSWERS[0].format("good")},
            {"from": "human", "value": QUESTIONS[1]},
            {"from": "gpt", "value": ANSWERS[1].format("fair")}]
    for group_by_length in (False, True):
        got = fn_t(template, [conv], t_tk, [3], group_by_length=group_by_length)[0]
        want = fn_j(template, [conv], j_tk, [3], group_by_length=group_by_length)[0]
        for field in ("input_ids", "labels", "attention_mask"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert got.mismatch == want.mismatch
    for pkg in (t_pre, j_pre):
        with pytest.raises(NotImplementedError):
            pkg.get_preprocess_function("no-such-template")


@pytest.mark.parametrize("group_by_length,gif_fps", [(False, 10.0), (True, 1.0)])
def test_datasets_and_batches_equal_jax(metas, tokenizers, group_by_length, gif_fps):
    t_tk, j_tk = tokenizers
    t_cfg, j_cfg = configs(2, t_tk)
    kw = dict(split="eval", num_segments=T, group_by_length=group_by_length, mos_scale=1.0,
              gif_fps=gif_fps)
    for meta in metas:
        t_set = t_ds.build_datasets(meta, t_tk, t_cfg, **kw)
        j_set = j_ds.build_datasets(meta, j_tk, j_cfg, **kw)
        assert type(t_set).__name__ == type(j_set).__name__ and len(t_set) == len(j_set)
        for i in range(len(j_set)):
            assert_samples_equal(t_set[i], j_set[i])
        if meta == metas[2]:
            assert len(t_set) == 2 * N_VIDEOS  # eval takes no repeat_time
            continue
        for i in range(len(j_set)):
            assert_samples_equal(t_set.get_text_item(i), j_set.get_text_item(i))
            np.testing.assert_array_equal(t_set.get_pixel_item(i), j_set.get_pixel_item(i))
            assert t_set.supports_uint8_pixels() and j_set.supports_uint8_pixels()
            np.testing.assert_array_equal(t_set.get_pixel_item_uint8(i),
                                          j_set.get_pixel_item_uint8(i))
        # the eval CLIs' batches: in order, the last one short, threaded loader
        t_smp_, j_smp_ = (pkg.ShardedBatchSampler(len(j_set), global_batch_size=2, shuffle=False,
                                                  drop_last=False) for pkg in (t_smp, j_smp))
        assert list(t_smp_) == list(j_smp_) == [[0, 1], [2, 3], [4]]
        t_batches = list(t_loader.DataLoader(t_set, t_smp_, num_workers=2))
        j_batches = list(j_loader.DataLoader(j_set, j_smp_, num_workers=2))
        assert len(t_batches) == len(j_batches) == 3
        for tb, jb in zip(t_batches, j_batches):
            for k, v in jb.arrays().items():
                assert tb.arrays()[k].dtype == v.dtype, k
                np.testing.assert_array_equal(tb.arrays()[k], v, err_msg=k)
            assert (tb.video_names, tb.answers) == (jb.video_names, jb.answers)
        tb = t_col.collate([t_set[0], t_set[3]], seq_multiple=64)
        jb = j_col.collate([j_set[0], j_set[3]], seq_multiple=64)
        for k, v in jb.arrays().items():
            np.testing.assert_array_equal(tb.arrays()[k], v, err_msg=k)


def test_samplers_equal_jax():
    lengths = np.random.default_rng(3).integers(10, 400, 37).tolist()
    for world in (1, 2):
        t_lg = t_smp.LengthGroupedSampler(lengths, batch_size=4, world_size=world, seed=5)
        j_lg = j_smp.LengthGroupedSampler(lengths, batch_size=4, world_size=world, seed=5)
        for epoch in (0, 1):
            t_lg.set_epoch(epoch), j_lg.set_epoch(epoch)
            assert list(t_lg) == list(j_lg)
        for rank in range(world):
            kw = dict(global_batch_size=4 * world, num_processes=world, process_index=rank,
                      seed=9)
            t_b, j_b = t_smp.ShardedBatchSampler(t_lg, **kw), j_smp.ShardedBatchSampler(j_lg, **kw)
            assert list(t_b) == list(j_b) and len(t_b) == len(j_b)
            t_b = t_smp.ShardedBatchSampler(len(lengths), shuffle=True, **kw)
            j_b = j_smp.ShardedBatchSampler(len(lengths), shuffle=True, **kw)
            t_b.set_epoch(2), j_b.set_epoch(2)
            assert list(t_b) == list(j_b)


# ------------------------------------------------------------ eval helpers --


def test_eval_helpers_equal_jax(tokenizers, tmp_path):
    t_tk, j_tk = tokenizers
    for text in ["", "The quality is bad and good.", "excellent", "It is fair.", "Good", "poorly"]:
        assert t_ev.word_to_level(text) == j_ev.word_to_level(text)
    rng = np.random.default_rng(1)
    im_end = t_tk.convert_tokens_to_ids("<|im_end|>")
    for _ in range(5):
        s = int(rng.integers(8, 30))
        preds = rng.integers(5, t_tk.vocab_size, s - 1)
        labels = np.full(s - 1, -100)
        n = int(rng.integers(0, 6))
        labels[s - 2 - n : s - 2] = rng.integers(5, 300, n)
        labels[s - 2] = im_end
        real = int(rng.integers(n + 3, s + 1))
        assert t_ev.decode_answer_span(t_tk, preds, labels, real, im_end) == \
            j_ev.decode_answer_span(j_tk, preds, labels, real, im_end)
    x, y = rng.normal(size=9).tolist(), rng.normal(size=9).tolist()
    assert t_ev.correlation_metrics(x, y) == j_ev.correlation_metrics(x, y)
    rows1 = [[f"v{i}.gif", "The quality is good.", rng.choice(WORDS), float(rng.uniform(0, 100)),
              int(rng.integers(0, 6))] for i in range(7)]
    rows2 = [r + [float(rng.uniform(0, 1))] for r in rows1]
    persp = [[r[0], r[1], r[3], r[5]] for r in rows2]
    for name, t_fn, j_fn, kw in (
            ("s1", t_ev.save_and_evaluate, j_ev.save_and_evaluate, dict(rows=rows1, stage=1)),
            ("s2", t_ev.save_and_evaluate, j_ev.save_and_evaluate, dict(rows=rows2, stage=2)),
            ("p", t_ev.save_perspective_results, j_ev.save_perspective_results,
             dict(rows=persp))):
        out = {}
        for side, fn in (("t", t_fn), ("j", j_fn)):
            files = dict(output_file=str(tmp_path / side / f"{name}.csv"),
                         metrics_file=str(tmp_path / side / f"{name}.txt"))
            out[side] = fn(**kw, **files), files
            fn(**kw, **files)  # the metrics file is appended to
        assert out["t"][0] == out["j"][0]
        for key in ("output_file", "metrics_file"):
            with open(out["t"][1][key], "rb") as a, open(out["j"][1][key], "rb") as b:
                assert a.read() == b.read(), (name, key)


# ------------------------------------------------------------- the CLIs --


def cli_argv(meta, out_dir, stage, lora=0):
    argv = ["--model_scale", "tiny", "--meta_path", meta, "--output_dir", out_dir,
            "--max_seq_length", str(MAX_LEN), "--bf16", "False", "--num_segments", str(T),
            "--dataloader_num_workers", "2", "--group_by_length", "False",
            "--drop_path_rate", "0.0", "--eval_batch_size", "2", "--seed", "3"]
    if lora:
        argv += ["--use_backbone_lora", str(lora), "--use_llm_lora", str(lora)]
    return argv


@pytest.fixture(scope="module")
def jax_trees(metas):
    """One JAX parameter tree per (stage, LoRA rank), as JAX's CLI would
    draw it from the seed (through one jitted init, `jit_init`); at stage 2
    a non-negative score head, and with adapters a `lora_b` drawn
    non-zero."""
    import jax

    trees = {}
    for stage, lora in ((1, 0), (2, 2), (2, 0)):
        args = j_args.parse_args("x", cli_argv(metas[0], "unused", stage, lora))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_common, "init_or_load_params", jit_init)
            _, _, params, _ = j_common.build_model_and_tokenizer(args, stage)
        params = jax.tree_util.tree_map(np.asarray, params)
        if stage == 2:
            rng = np.random.default_rng(7)

            def edit(path, x):
                name = str(path[-1].key)
                if name == "lora_b":
                    return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
                if "mlpscore" in str(path) and name == "kernel":
                    return np.abs(x)
                return x
            params = jax.tree_util.tree_map_with_path(edit, params)
        trees[stage, lora] = params
    return trees


def tree_key(config):
    return config.stage, config.use_llm_lora


@pytest.fixture
def same_weights(jax_trees, monkeypatch):
    """Both CLIs take the tree of their stage and LoRA rank: JAX through its
    `init_or_load_params`, the port through `model_weights`."""
    def port_weights(args, config):
        return state_dict_from_jax(jax_trees[tree_key(config)], config)

    monkeypatch.setattr(j_common, "init_or_load_params",
                        lambda model, args, config, seed=0: jax_trees[tree_key(config)])
    monkeypatch.setattr(t_common, "model_weights", port_weights)


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def read_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in (line.rstrip("\n").split(": ") for line in f)}


def assert_metrics_close(got, want):
    assert list(got) == list(want)
    for k in want:
        assert np.isclose(got[k], want[k], rtol=METRIC_TOL, atol=METRIC_TOL, equal_nan=True), k


@pytest.fixture(scope="module")
def jax_run(metas, jax_trees, tmp_path_factory):
    """-> run(name, stage, lora, *extra): the output directory of the JAX
    CLI's run, made once per name."""
    out = tmp_path_factory.mktemp("jax_cli")
    done = {}

    def run(name, stage, lora, *extra):
        if name not in done:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_common, "init_or_load_params",
                           lambda model, args, config, seed=0: jax_trees[tree_key(config)])
                main = j_stage1.main if stage == 1 else j_stage2.main
                main(cli_argv(metas[0], str(out / name), stage, lora) + list(extra))
            done[name] = out / name
        return done[name]
    return run


@pytest.fixture
def shared_prefixes(monkeypatch):
    """The `shared_prefix_len` of every `score_batch` call."""
    from aigv_assessor_torch.cli import score as t_score

    seen, real = [], t_score.score_batch

    def spy(model, ids, pixels, mask, shared_prefix_len=None, *a, **kw):
        seen.append(shared_prefix_len)
        return real(model, ids, pixels, mask, shared_prefix_len, *a, **kw)
    monkeypatch.setattr(t_score, "score_batch", spy)
    return seen


def test_stage1_eval_cli_equals_jax(metas, jax_run, same_weights, tmp_path):
    metrics = t_stage1.main(cli_argv(metas[0], str(tmp_path), 1) + ["--device", "cpu"])
    ref = jax_run("s1", 1, 0)
    got, want = read_csv(tmp_path / "results.csv"), read_csv(ref / "results.csv")
    assert got[0] == want[0] == ["video_name", "answer", "output", "mos", "level"]
    assert len(got) == len(want) == N_VIDEOS + 1
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3] and g[4] == w[4]  # name, answer, output words, level
        assert float(g[3]) == float(w[3])
    want_metrics = read_metrics(ref / "metrics.txt")
    assert_metrics_close(read_metrics(tmp_path / "metrics.txt"), want_metrics)
    assert np.isclose(metrics["accuracy"], want_metrics["Accuracy"])


@pytest.mark.parametrize("lora", [2, 0], ids=["lora2", "no_lora"])
def test_stage2_eval_cli_solo_and_fused_equal_jax(metas, jax_run, same_weights, shared_prefixes,
                                                  tmp_path, lora):
    """With rank-2 adapters (merged by the port's build, live in JAX's) and
    without: the solo CLI's rows and pred_score against JAX's; the fused
    CLI, on the shared prefix in every batch, against JAX's fused CLI and
    the port's solo CLI."""
    port = ["--device", "cpu"]
    t_stage2.main(cli_argv(metas[0], str(tmp_path / "s2"), 2, lora) + port)
    ref_solo = jax_run(f"s2_r{lora}", 2, lora)
    got, want = read_csv(tmp_path / "s2" / "results.csv"), read_csv(ref_solo / "results.csv")
    assert got[0] == want[0] == ["video_name", "answer", "output", "mos", "level", "pred_score"]
    assert len(got) == len(want) == N_VIDEOS + 1
    solo = {}
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3] and g[4] == w[4]
        assert float(g[3]) == float(w[3])
        assert abs(float(g[5]) - float(w[5])) <= SCORE_TOL
        solo[g[0]] = float(g[5])
    assert max(abs(v) for v in solo.values()) > 0  # the score head is open
    assert list(read_metrics(tmp_path / "s2" / "metrics.txt")) == list(
        read_metrics(ref_solo / "metrics.txt"))

    fused = ["--fused_meta_paths", metas[1]]
    t_stage2.main(cli_argv(metas[0], str(tmp_path / "fused"), 2, lora) + port + fused)
    assert shared_prefixes and all(n and n > 0 for n in shared_prefixes), shared_prefixes
    ref_fused = jax_run(f"fused_r{lora}", 2, lora, *fused)
    for p in (1, 2):
        got = read_csv(tmp_path / "fused" / f"results_p{p}.csv")
        want = read_csv(ref_fused / f"results_p{p}.csv")
        assert got[0] == want[0] == ["video_name", "answer", "mos", "pred_score"]
        assert len(got) == len(want) == N_VIDEOS + 1
        for g, w in zip(got[1:], want[1:]):
            assert g[:2] == w[:2] and float(g[2]) == float(w[2])
            assert abs(float(g[3]) - float(w[3])) <= SCORE_TOL
            if p == 1:  # the first perspective is the solo eval's meta
                assert abs(float(g[3]) - solo[g[0]]) <= SCORE_TOL
        assert list(read_metrics(tmp_path / "fused" / f"metrics_p{p}.txt")) == [
            "SRCC_score", "PLCC_score", "KRCC_score"]


def test_fused_eval_tolerance_catches_a_prefix_one_token_long(metas, jax_run, same_weights,
                                                             monkeypatch, tmp_path):
    """The control of the check above: a shared prefix one token too long
    gives the second perspective the first one's question token, and its
    scores leave JAX's by more than SCORE_TOL; the first perspective's stay
    within it."""
    from aigv_assessor_torch.cli import score as t_score

    real = t_score.compute_shared_prefix_len
    monkeypatch.setattr(t_score, "compute_shared_prefix_len",
                        lambda *a, **kw: real(*a, **kw) + 1)
    fused = ["--fused_meta_paths", metas[1]]
    t_stage2.main(cli_argv(metas[0], str(tmp_path), 2) + ["--device", "cpu"] + fused)
    ref = jax_run("fused_r0", 2, 0, *fused)
    err = {}
    for p in (1, 2):
        got = read_csv(tmp_path / f"results_p{p}.csv")[1:]
        want = read_csv(ref / f"results_p{p}.csv")[1:]
        err[p] = max(abs(float(g[3]) - float(w[3])) for g, w in zip(got, want))
    assert err[1] <= SCORE_TOL < err[2], err


def test_fused_eval_rejects_mismatched_videos_and_runs_w8a8(metas, tokenizers, capsys,
                                                           tmp_path):
    """Pairing: perspectives over videos in another order raise. `--eval_w8a8`
    quantizes the same seeded weights (the drift bound of
    tests/test_fused_eval.py)."""
    t_tk, _ = tokenizers
    cfg, _ = configs(2, t_tk)
    model = t_common.build_serving_model(cfg, device="cpu", precision=Precision.fp32(),
                                         seed=0)
    with open(json.load(open(metas[1]))["persp1"]["annotation"]) as f:
        rows = [json.loads(line) for line in f if line.strip()][::-1]
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in rows))
    meta = json.load(open(metas[1]))
    meta["persp1"]["annotation"] = str(bad)
    (tmp_path / "bad_meta.json").write_text(json.dumps(meta))
    sets = [t_ds.build_datasets(m, t_tk, cfg, split="eval", num_segments=T)
            for m in (metas[0], str(tmp_path / "bad_meta.json"))]
    with pytest.raises(ValueError, match="pairs a different video"):
        t_ev.evaluate_perspectives(model, sets, batch_size=2)
    multi = t_ds.build_datasets(metas[2], t_tk, cfg, split="eval", num_segments=T)
    with pytest.raises(ValueError, match="exactly ONE"):
        t_ev.evaluate_perspectives(model, [multi, multi], batch_size=2)

    base = ["--model_scale", "tiny", "--meta_path", metas[0], "--max_seq_length", str(MAX_LEN),
            "--bf16", "False", "--num_segments", str(T), "--eval_batch_size", "2",
            "--device", "cpu", "--fused_meta_paths", metas[1]]
    scores = {}
    for mode in ("fp32", "w8a8"):
        out = tmp_path / mode
        extra = ["--eval_w8a8", "True"] if mode == "w8a8" else []
        metrics = t_stage2.main(base + ["--output_dir", str(out)] + extra)
        assert set(metrics) == {"p1", "p2"}
        scores[mode] = [[float(r[3]) for r in read_csv(out / f"results_p{p}.csv")[1:]]
                        for p in (1, 2)]
        assert "fused eval: %d videos x 2 perspectives" % N_VIDEOS in capsys.readouterr().out
    b, q = np.asarray(scores["fp32"]), np.asarray(scores["w8a8"])
    assert b.shape == q.shape == (2, N_VIDEOS) and np.isfinite(q).all()
    spread = np.abs(b).max() or 1.0
    assert np.abs(b - q).max() <= 0.15 * spread + 0.05
    # `--vision_path` grafts a tower: the run's own seeded tower gives the same
    # scores, another seed's tower other scores
    seed = t_args.parse_args("eval", base + ["--output_dir", "unused"]).seed
    for tower_seed in (seed, seed + 7):
        tower = t_common.build_serving_model(cfg, device="cpu", precision=Precision.fp32(),
                                             seed=tower_seed)
        part = tmp_path / f"vit{tower_seed}.msgpack"
        save_jax_params(str(part), {"params": {"vision_model":
                                               jax_tree(tower)["params"]["vision_model"]}})
        out = tmp_path / f"graft{tower_seed}"
        t_stage2.main(base + ["--output_dir", str(out), "--vision_path", str(part)])
        grafted = [[float(r[3]) for r in read_csv(out / f"results_p{p}.csv")[1:]]
                   for p in (1, 2)]
        assert (grafted == scores["fp32"]) == (tower_seed == seed), tower_seed



def _fused_scores(out):
    """{perspective: {video: pred_score}} of a fused eval's output."""
    return {p: {r[0]: float(r[3]) for r in read_csv(out / f"results_p{p}.csv")[1:]}
            for p in (1, 2)}


def test_stage2_eval_w8a8_live_adapters_equal_jax(metas, jax_trees, jax_run, same_weights,
                                                  monkeypatch, tmp_path):
    """`--eval_w8a8 True` on a stage-2 checkpoint with rank-2 adapters
    (non-zero `lora_b`): JAX's fused eval quantizes the bases alone and runs
    the adapters live over them; so does the port's, within W8A8_SCORE_TOL
    of JAX's scores in both perspectives. The solo eval, which takes no W8A8
    in either package, stays within SCORE_TOL. Control: the adapters folded
    into the fp32 bases by `merge_lora_` and then quantized (the port's
    build before), run without adapters, leave JAX's scores by more than
    W8A8_SCORE_TOL."""
    flags = ["--device", "cpu", "--eval_w8a8", "True"]
    fused = ["--fused_meta_paths", metas[1]]
    t_stage2.main(cli_argv(metas[0], str(tmp_path / "solo"), 2, 2) + flags)
    ref_solo = jax_run("s2_r2_w8a8", 2, 2, "--eval_w8a8", "True")
    got, want = read_csv(tmp_path / "solo" / "results.csv"), read_csv(ref_solo / "results.csv")
    assert len(got) == len(want) == N_VIDEOS + 1
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] and abs(float(g[5]) - float(w[5])) <= SCORE_TOL

    t_stage2.main(cli_argv(metas[0], str(tmp_path / "live"), 2, 2) + flags + fused)
    ref = _fused_scores(jax_run("fused_r2_w8a8", 2, 2, "--eval_w8a8", "True", *fused))

    def merged_weights(args, config):
        lora = config.replace(use_backbone_lora=2, use_llm_lora=2)
        model = TorchAssessor(lora, Precision.fp32())
        model.load_state_dict(state_dict_from_jax(jax_trees[tree_key(lora)], lora), strict=True)
        return lora_free_state_dict(merge_lora_(model))

    monkeypatch.setattr(t_common, "model_weights", merged_weights)
    t_stage2.main(cli_argv(metas[0], str(tmp_path / "merged"), 2) + flags + fused)
    err = {}
    for name in ("live", "merged"):
        got = _fused_scores(tmp_path / name)
        assert all(set(got[p]) == set(ref[p]) for p in ref)
        err[name] = max(abs(got[p][k] - ref[p][k]) for p in ref for k in ref[p])
    assert max(abs(v) for p in ref for v in ref[p].values()) > 0  # the score head is open
    assert err["live"] <= W8A8_SCORE_TOL < err["merged"], err
