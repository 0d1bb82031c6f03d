"""The port's checkpoint and data tools (`aigv_assessor_torch/tools/`)
against the JAX package's (`aigv_assessor_tpu/tools/`), on the CPU, bit for
bit:

- `merge_lora_tree` on a tiny tree with rank-2 adapters in both towers
  (`lora_b` drawn non-zero), every leaf and the msgpack bytes;
- `quantize_tree` (the default pick, `scope=''`, and the W8A8 pick with
  `exclude` / `only_base`), `quantize_tree_int4`, `dequantize_tree`,
  `strip_int4_meta`; the int4 packing and its inverse at odd in-dims, flat
  and stacked;
- `resize_pos_embed`, growing and shrinking the grid;
- `json2jsonl` / `jsonl2jsonl`: the output files' bytes;
- `convert_parquet` on two parquet shards written with pandas (an image as
  raw bytes, then as a `{"bytes": ...}` struct): the JSONL and every JPEG;
- `extract_video_frames` on a GIF and an mp4: every JPEG;
- `make_synthetic_ckpt`: the SlowFast leaves in the order of flax's
  `flatten_dict` over `SlowFastR50.init` (tiny and default widths), and
  every file for seed 0 and for seed 3 without SlowFast;
- `convert_weights`' command line on one sharded synthetic checkpoint: the
  port's `python -m` against JAX's `main`, the written `params.msgpack` byte
  for byte and the printed line, with the towers stacked and (a config
  with `scan_layers` false) unrolled; `--strict` refusing an unmapped key in
  both, which without it both skip.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from aigv_assessor_torch.models.loading import flatten_tree
from aigv_assessor_torch.tools import convert_to_int8 as t_q
from aigv_assessor_torch.tools import merge_lora as t_merge
from aigv_assessor_torch.tools import resize_pos_embed as t_resize
from aigv_assessor_torch.utils import flax_msgpack
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.tools import convert_to_int8 as j_q
from aigv_assessor_tpu.tools import merge_lora as j_merge
from aigv_assessor_tpu.tools import resize_pos_embed as j_resize

from tests._torch_cli_fixtures import open_tree


@pytest.fixture(scope="module")
def lora_tree():
    """(JAX tree with numpy leaves, the port's tree read from its bytes)."""
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=4, use_backbone_lora=2,
                                               use_llm_lora=2)
    params = jax.jit(AIGVAssessor(cfg, Precision.fp32()).init)(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32), jnp.zeros((1, 4, 56, 56, 3)))
    params = open_tree(jax.device_get(params), lora_b_seed=1)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, flax_msgpack.restore(serialization.msgpack_serialize(params))


def _assert_trees_equal(got, want):
    """Same paths in the same order, every leaf bit for bit, same bytes."""
    flat_w = {"/".join(map(str, k)): v for k, v in traverse_util.flatten_dict(want).items()}
    flat_g = flatten_tree(got)
    assert list(flat_g) == list(flat_w)
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.numpy().dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    assert flax_msgpack.serialize(got) == serialization.msgpack_serialize(want)


def test_merge_lora_equals_jax(lora_tree):
    params, tree = lora_tree
    want = j_merge.merge_lora_tree(params, 0, 0)
    got = t_merge.merge_lora_tree(tree, device="cpu")
    _assert_trees_equal(got, want)
    assert not any(k.endswith(("lora_a", "lora_b")) for k in flatten_tree(got))


@pytest.mark.parametrize("kind", ["int8", "int8_all", "w8a8_pick", "int4"])
def test_quantize_and_dequantize_equal_jax(lora_tree, kind):
    params, tree = lora_tree
    if kind == "int8":
        want, got = j_q.quantize_tree(params), t_q.quantize_tree(tree)
    elif kind == "int8_all":
        want, got = j_q.quantize_tree(params, scope=""), t_q.quantize_tree(tree, scope="")
    elif kind == "w8a8_pick":
        kw = dict(scope=("language_model", "vision_model"), exclude=("output", "o_proj"),
                  only_base=True)
        want, got = j_q.quantize_tree(params, **kw), t_q.quantize_tree(tree, **kw)
    else:
        want, got = j_q.quantize_tree_int4(params), t_q.quantize_tree_int4(tree)
    _assert_trees_equal(got, want)
    _assert_trees_equal(t_q.dequantize_tree(got), j_q.dequantize_tree(want))
    if kind == "int4":
        _assert_trees_equal(t_q.strip_int4_meta(got), j_q.strip_int4_meta(want))


@pytest.mark.parametrize("shape", [(7, 5), (2, 9, 4), (6, 3), (1, 1)])
def test_int4_packing_equals_jax(shape):
    w = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    w[..., 0, 0] = 0.0
    packed, scale = j_q.quantize_kernel_int4(w)
    got_p, got_s = t_q.quantize_kernel_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(got_p.numpy(), packed)
    np.testing.assert_array_equal(got_s.numpy(), scale)
    np.testing.assert_array_equal(
        t_q.dequantize_kernel_int4(got_p, got_s, shape[-2]).numpy(),
        j_q.dequantize_kernel_int4(packed, scale, shape[-2]))
    q8, s8 = j_q.quantize_kernel(w)
    got_q8, got_s8 = t_q.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q8.numpy(), q8)
    np.testing.assert_array_equal(got_s8.numpy(), s8)
    np.testing.assert_array_equal(t_q.dequantize_kernel(got_q8, got_s8).numpy(),
                                  j_q.dequantize_kernel(q8, s8))


@pytest.mark.parametrize("old,new", [(56, 84), (84, 56), (448, 336)])
def test_resize_pos_embed_equals_jax(old, new):
    c = 32
    pe = np.random.default_rng(4).normal(size=(1, 1 + (old // 14) ** 2, c)).astype(np.float32)
    want = j_resize.resize_pos_embed(pe, old, new, 14)
    got = t_resize.resize_pos_embed(torch.from_numpy(pe), old, new, 14)
    assert tuple(got.shape) == want.shape == (1, 1 + (new // 14) ** 2, c)
    np.testing.assert_array_equal(got.numpy(), want)


ROWS = [
    {"id": "a->1", "video": "x.mp4", "conversations": [
        {"from": "system", "value": "sys"}, {"from": "human", "value": "ü <video>"},
        {"from": "gpt", "value": "good"}]},
    {"id": 7, "video": "y.mp4", "conversations": [
        {"from": "human", "value": "q"}, {"from": "gpt", "value": "bad"}]},
    {"video": "z.mp4"},
]


def test_json_converters_equal_jax(tmp_path):
    from aigv_assessor_torch.tools import json2jsonl as t_j2, jsonl2jsonl as t_l2
    from aigv_assessor_tpu.tools import json2jsonl as j_j2, jsonl2jsonl as j_l2

    src = tmp_path / "in.json"
    src.write_text(json.dumps(ROWS, ensure_ascii=False))
    lines = tmp_path / "in.jsonl"
    lines.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in ROWS[:2]) + "\n\n"
                     + json.dumps(ROWS[2]) + "\n")
    for mod_t, mod_j, inp in ((t_j2, j_j2, src), (t_l2, j_l2, lines)):
        mod_t.main([str(inp), str(tmp_path / "t.jsonl")])
        mod_j.main([str(inp), str(tmp_path / "j.jsonl")])
        assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()


def test_convert_parquet_equals_jax(tmp_path):
    import io

    import pandas as pd
    from PIL import Image

    from aigv_assessor_torch.tools import convert_parquet as t_cp
    from aigv_assessor_tpu.tools import convert_parquet as j_cp

    rng = np.random.default_rng(5)
    shards = []
    for i in range(2):  # raw bytes, then the {"bytes": ...} struct HF datasets write
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (20 + i, 30, 3), dtype=np.uint8)).save(buf, "PNG")
        image = {"bytes": buf.getvalue()} if i else buf.getvalue()
        shards.append(tmp_path / f"shard{i}.parquet")
        pd.DataFrame({"image": [image], "question": [["what?", "wie viel ü?"][i]],
                      "answer": [["a", "3"][i]]}).to_parquet(shards[-1])
    for name, mod in (("t", t_cp), ("j", j_cp)):
        mod.main([*map(str, shards), "--image_dir", str(tmp_path / f"{name}_img"),
                  "--output", str(tmp_path / f"{name}.jsonl")])
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    names = sorted(os.listdir(tmp_path / "j_img"))
    assert names == sorted(os.listdir(tmp_path / "t_img")) == ["00000000.jpg", "00000001.jpg"]
    for n in names:
        assert (tmp_path / "t_img" / n).read_bytes() == (tmp_path / "j_img" / n).read_bytes()


def test_extract_video_frames_equals_jax(tmp_path):
    import cv2
    from PIL import Image

    from aigv_assessor_torch.tools import extract_video_frames as t_ev
    from aigv_assessor_tpu.tools import extract_video_frames as j_ev

    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(6)
    frames = [Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
              for _ in range(10)]
    frames[0].save(videos / "clip.gif", save_all=True, append_images=frames[1:], duration=100)
    w = cv2.VideoWriter(str(videos / "movie.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for _ in range(12):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    (videos / "notes.txt").write_text("not a video")
    for name, mod in (("t", t_ev), ("j", j_ev)):
        mod.main(["--video_dir", str(videos), "--out_dir", str(tmp_path / name),
                  "--num_frames", "4", "--workers", "2"])
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "clip", "movie"]
    for video in ("clip", "movie"):
        names = sorted(os.listdir(tmp_path / "j" / video))
        assert names == sorted(os.listdir(tmp_path / "t" / video)) == [
            f"{i:04d}.jpg" for i in range(4)]
        for n in names:
            assert ((tmp_path / "t" / video / n).read_bytes()
                    == (tmp_path / "j" / video / n).read_bytes())


def test_slowfast_paths_in_flax_order():
    from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
    from aigv_assessor_torch.tools.make_synthetic_ckpt import slowfast_paths
    from aigv_assessor_tpu.models.motion import SlowFastR50

    for cfg, tcfg in ((AssessorConfig.tiny(stage=2), TorchConfig.tiny(stage=2)),
                      (AssessorConfig(), TorchConfig())):
        model = SlowFastR50(cfg.motion, Precision.fp32())
        t = max(cfg.motion.alpha, 8)
        shapes = jax.eval_shape(model.init, jax.random.key(0),
                                jnp.zeros((1, t, cfg.vision.image_size, cfg.vision.image_size, 3)))
        want = [(tuple(map(str, k)), tuple(v.shape))
                for k, v in traverse_util.flatten_dict(shapes["params"]).items()]
        assert slowfast_paths(tcfg) == want


@pytest.mark.parametrize("seed,slowfast", [(0, True), (3, False)])
def test_make_synthetic_ckpt_files_equal_jax(tmp_path, seed, slowfast):
    from aigv_assessor_torch.tools import make_synthetic_ckpt as t_mk
    from aigv_assessor_tpu.tools import make_synthetic_ckpt as j_mk

    flags = ["--seed", str(seed)] + ([] if slowfast else ["--no-slowfast"])
    t_mk.main(["--out", str(tmp_path / "t")] + flags)
    j_mk.main(["--out", str(tmp_path / "j")] + flags)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and "tokenizer.json" in names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


@pytest.fixture(scope="module")
def synthetic_ckpt(tmp_path_factory):
    """One tiny sharded reference checkpoint, and a file with a key that no
    model has."""
    from safetensors.numpy import save_file

    from aigv_assessor_tpu.tools.make_synthetic_ckpt import make_synthetic_checkpoint

    d = tmp_path_factory.mktemp("convert_ckpt")
    make_synthetic_checkpoint(str(d / "ckpt"), stage=2, n_shards=2, seed=0)
    save_file({"not_a_module.weight": np.ones((2, 3), np.float32)}, str(d / "extra.safetensors"))
    return d


def _convert_both(d, config, extra=(), flags=()):
    """The port's tool as `python -m`, JAX's through its `main`: -> (port's
    file, JAX's file, port's stdout, JAX's stdout)."""
    from aigv_assessor_tpu.tools import convert_weights as j_conv

    ckpt = [str(d / "ckpt"), *extra]
    argv = lambda out: ["--torch_ckpt", *ckpt, "--config", str(config), "--out", str(out),
                        *flags]
    t_out, j_out = d / "t.msgpack", d / "j.msgpack"
    for f in (t_out, j_out):
        f.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, "-m", "aigv_assessor_torch.tools.convert_weights",
                          *argv(t_out)], capture_output=True, text=True, env=env)
    assert run.returncode == 0, run.stderr
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        j_conv.main(argv(j_out))
    return t_out.read_bytes(), j_out.read_bytes(), run.stdout, printed.getvalue()


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
def test_convert_weights_cli_writes_jax_bytes(synthetic_ckpt, scan_layers):
    d = synthetic_ckpt
    config = d / "ckpt" / "config.json"
    if not scan_layers:
        cfg = json.loads(config.read_text())
        for tower in ("vision_config", "llm_config"):
            cfg[tower]["scan_layers"] = False
        config = d / "config_unrolled.json"
        config.write_text(json.dumps(cfg))
    got, want, t_said, j_said = _convert_both(d, config, flags=["--strict"])
    assert got == want
    said = t_said.strip().splitlines()[-1]
    assert said == j_said.strip().splitlines()[-1].replace("j.msgpack", "t.msgpack")
    assert said.startswith(f"wrote {d / 't.msgpack'}: ") and said.endswith("M params")
    tree = flax_msgpack.restore(got)["params"]
    layers = "layers" if scan_layers else "layers_0"
    assert layers in tree["language_model"]


def test_convert_weights_strict_refuses_an_unmapped_key(synthetic_ckpt):
    from aigv_assessor_tpu.tools import convert_weights as j_conv
    from aigv_assessor_torch.tools import convert_weights as t_conv

    d = synthetic_ckpt
    argv = ["--torch_ckpt", str(d / "ckpt"), str(d / "extra.safetensors"), "--config",
            str(d / "ckpt" / "config.json"), "--out", str(d / "strict.msgpack"), "--strict"]
    for tool in (t_conv, j_conv):
        with pytest.raises(ValueError, match="1 unmapped checkpoint keys"):
            tool.main(argv)
    assert not (d / "strict.msgpack").exists()
    # without --strict both skip the key and write what they write without it
    got, want, _, _ = _convert_both(d, d / "ckpt" / "config.json",
                                    extra=[str(d / "extra.safetensors")])
    clean, _, _, _ = _convert_both(d, d / "ckpt" / "config.json")
    assert got == want == clean

