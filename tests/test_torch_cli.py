"""The port's score CLI and its host side against the JAX package, on the CPU.

Fixtures: GIFs written by PIL, mp4 files written by `cv2.VideoWriter`, a
folder of PNG frames, and a reference-format checkpoint from
`aigv_assessor_tpu/tools/make_synthetic_ckpt.py` (sharded bf16 safetensors,
config.json, tokenizer.json) at the tiny stage-2 scale.

- `data/video.py` and `data/native_decode.py` against the JAX copies, frame
  for frame, on every fixture, with the native decoder and with OpenCV; a
  decoder library that does not load counts as absent;
- the tokenizer's ids against JAX's, on the checkpoint's tokenizer.json and
  on `build_test_tokenizer`; `build_prompt_ids`, `list_videos` and JAX's
  switch parsing equal;
- `AssessorConfig.from_dict` field for field against JAX's;
- `load_reference_checkpoint` bit-equal, key for key, to
  `state_dict_from_jax` of the JAX converter's tree, and so is that tree
  written as flax's `params.msgpack` and read through `model_weights`; the
  port loaded from the
  checkpoint against JAX's `score_perspectives` on the converted params and
  the same uint8 frames under each `normalize_type` (fp32, 2e-4, the slice
  tolerance of tests/test_torch_models.py);
- `cli/score.main` on the fixtures: the CSV header as JAX writes it, one row
  per video, finite scores equal to `score_chunks` called directly on the
  same decoded frames, and the JSON summary line's keys; with
  `--device_preprocess False --normalize_type clip` the frames the CLI
  normalizes on the host equal JAX's `transform_frames` at its defaults (the
  ImageNet statistics, as JAX's CLI normalizes there) to 1e-6.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import contextlib
import csv
import dataclasses
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.cli import score as t_score
from aigv_assessor_torch.core import config as tcfg
from aigv_assessor_torch.data import native_decode as t_native
from aigv_assessor_torch.data import tokenizer as t_tok
from aigv_assessor_torch.data import video as t_video
from aigv_assessor_torch.models.loading import load_reference_checkpoint, state_dict_from_jax
from aigv_assessor_tpu.cli import score as j_score
from aigv_assessor_tpu.core import config as jcfg
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.data import native_decode as j_native
from aigv_assessor_tpu.data import tokenizer as j_tok
from aigv_assessor_tpu.data import video as j_video
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.ops import quant_fuse as jqf
from aigv_assessor_tpu.ops.preprocess import resize_normalize
from aigv_assessor_tpu.tools.convert_weights import convert, load_torch_state_dict
from aigv_assessor_tpu.tools.make_synthetic_ckpt import (
    make_synthetic_checkpoint,
    reference_config_dict,
)

TOL = 2e-4  # fp32 slice, tests/test_torch_models.py
T = 4  # frames per video
QUESTIONS = ["How would you rate the static quality of this video?",
             "How would you rate the temporal smoothness of this video?"]
# the keys of the JAX CLI's summary line (aigv_assessor_tpu/cli/score.py:269-282)
SUMMARY_KEYS = {"metric", "value", "unit", "n_videos", "n_perspectives",
                "perspective_scores_per_sec", "out"}


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A directory of 2 GIFs and 2 mp4 files, a folder of frames beside it."""
    import cv2

    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    for i in range(2):
        frames = [Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
                  for _ in range(10 + i)]
        frames[0].save(d / f"clip{i}.gif", save_all=True, append_images=frames[1:],
                       duration=100)
        w = cv2.VideoWriter(str(d / f"movie{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                            (64, 48))
        for _ in range(12 + 3 * i):
            w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        w.release()
    folder = tmp_path_factory.mktemp("frames")
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
            folder / f"f{i:02d}.png")
    return str(d), str(folder)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("synthetic_ckpt")
    cfg = make_synthetic_checkpoint(str(d), stage=2, n_shards=2, seed=0)
    return str(d), cfg


@contextlib.contextmanager
def native_absent():
    """Both packages' native decoder reported absent: decoding goes to OpenCV."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_native, "available", lambda: False)
        mp.setattr(j_native, "available", lambda: False)
        yield


def _arrays(frames):
    return [np.asarray(f.convert("RGB")) for f in frames]


# ------------------------------------------------------------ video decode --


@pytest.mark.parametrize("native", [True, False], ids=["native", "opencv"])
@pytest.mark.parametrize("out_size", [None, 56])
def test_load_video_equals_jax(media, native, out_size):
    d, folder = media
    if native and not t_native.available():
        pytest.skip("native/libvideodec.so does not load here")
    paths = sorted(os.path.join(d, f) for f in os.listdir(d)) + [folder]
    with contextlib.ExitStack() as stack:
        if not native:
            stack.enter_context(native_absent())
        for path in paths:
            got = t_video.load_video(path, num_segments=T, out_size=out_size)
            want = j_video.load_video(path, num_segments=T, out_size=out_size)
            assert len(got) == len(want) == T
            for g, w in zip(_arrays(got), _arrays(want)):
                np.testing.assert_array_equal(g, w)
            # GIF and folder readers ignore out_size: their frames keep their size
            if out_size and (path.endswith(".gif") or os.path.isdir(path)):
                assert got[0].size != (out_size, out_size)


@pytest.mark.parametrize("normalize_type", ["imagenet", "clip", "siglip"])
def test_frame_transforms_equal_jax(media, normalize_type):
    d, _ = media
    frames = t_video.load_video(os.path.join(d, "movie1.mp4"), num_segments=T)
    np.testing.assert_array_equal(t_video.frames_to_uint8(frames, 56),
                                  j_video.frames_to_uint8(frames, 56))
    for pad2square in (False, True):
        np.testing.assert_array_equal(
            t_video.transform_frames(frames, 56, normalize_type=normalize_type,
                                     pad2square=pad2square),
            j_video.transform_frames(frames, 56, normalize_type=normalize_type,
                                     pad2square=pad2square))
    img = frames[0].resize((130, 70))
    got = t_video.dynamic_preprocess(img, max_num=6, image_size=28, use_thumbnail=True)
    want = j_video.dynamic_preprocess(img, max_num=6, image_size=28, use_thumbnail=True)
    assert [np.asarray(g).tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    for n, fps, bound in ((8, 30.0, None), (4, 10.0, (0.2, 1.1)), (3, 24.0, None)):
        np.testing.assert_array_equal(t_video.get_frame_indices(n, fps, 57, 0, bound),
                                      j_video.get_frame_indices(n, fps, 57, 0, bound))


def test_native_decoder_equals_jax_and_a_broken_library_counts_as_absent(media, tmp_path):
    d, _ = media
    path = os.path.join(d, "movie0.mp4")
    if t_native.available():
        assert t_native.probe(path) == j_native.probe(path)
        for g, w in zip(t_native.sample_frames(path, T, out_size=(32, 24)),
                        j_native.sample_frames(path, T, out_size=(32, 24))):
            np.testing.assert_array_equal(g, w)
    bad = tmp_path / "libvideodec.so"
    bad.write_bytes(b"not a shared library")
    with pytest.MonkeyPatch.context() as mp:
        for so in (str(bad), str(tmp_path / "missing.so")):
            mp.setattr(t_native, "_SO_PATH", so)
            mp.setattr(t_native, "_LIB", None)
            mp.setattr(t_native, "_MISSING", False)
            assert not t_native.available()  # OSError from ctypes: absent, not raised
            frames = t_video.load_video(path, num_segments=T)
            with native_absent():
                want = j_video.load_video(path, num_segments=T)
            for g, w in zip(_arrays(frames), _arrays(want)):
                np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ tokenizer, prompts --


def test_tokenizer_ids_equal_jax(ckpt):
    d, _ = ckpt
    texts = ["How would you rate the static quality of this video?",
             "Frame1: <image>\nMotion Feature: <IMG_CONTEXT><img></img> quality good."]
    for got, want in ((t_tok.AIGVTokenizer.from_pretrained(d),
                       j_tok.AIGVTokenizer.from_pretrained(d)),
                      (t_tok.build_test_tokenizer(64), j_tok.build_test_tokenizer(64))):
        assert got.vocab_size == want.vocab_size
        for name in ("bos_token_id", "eos_token_id", "pad_token_id", "img_context_token_id"):
            assert getattr(got, name) == getattr(want, name)
        for text in texts:
            assert got.encode(text) == want.encode(text)
            assert got(text, padding="max_length", max_length=64, truncation=True) == want(
                text, padding="max_length", max_length=64, truncation=True)
        assert got.decode(got.encode(texts[0])) == want.decode(want.encode(texts[0]))


def test_prompts_and_video_list_equal_jax(media, tmp_path):
    d, _ = media
    tok = t_tok.build_test_tokenizer()
    jtok = j_tok.build_test_tokenizer()
    for q in QUESTIONS:
        assert t_score.build_prompt_ids(tok, "internlm2-chat", q, 8, 256) == \
            j_score.build_prompt_ids(jtok, "internlm2-chat", q, 8, 256)
    jsonl = tmp_path / "videos.jsonl"
    jsonl.write_text("".join(json.dumps({"video": f"v{i}.mp4"}) + "\n" for i in range(3)) + "\n")
    for path in (d, str(jsonl), os.path.join(d, "clip0.gif")):
        assert t_score.list_videos(path) == j_score.list_videos(path)


@pytest.mark.parametrize("value", [None, "0", "1", "vit", "llm", "vit,llm", "llm,other", ""])
def test_switch_parse_equals_jax(value):
    env = {} if value is None else {"AIGV_FUSE_QUANT": value, "AIGV_QUANT_ROWS": value}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", env)
        for name, gate in (("AIGV_FUSE_QUANT", jqf.fuse_enabled),
                           ("AIGV_QUANT_ROWS", jqf.quant_rows_enabled)):
            got = t_common.quant_components(name)
            assert got == {c for c in ("vit", "llm") if gate(c)}, (name, value, got)


# ------------------------------------------------------------------ config --


@pytest.mark.parametrize("scale", ["tiny", "2b"])
def test_config_from_dict_equals_jax(ckpt, scale):
    from aigv_assessor_tpu.cli.common import LLM_2B

    d, cfg = ckpt
    if scale == "2b":
        cfg = jcfg.AssessorConfig(llm=LLM_2B, stage=2)
    raw = json.loads(json.dumps(reference_config_dict(cfg)))  # as config.json holds it
    got, want = tcfg.AssessorConfig.from_dict(raw), jcfg.AssessorConfig.from_dict(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_image_token == want.num_image_token
    if scale == "tiny":
        loaded = tcfg.AssessorConfig.from_json(os.path.join(d, "config.json"))
        assert dataclasses.asdict(loaded) == dataclasses.asdict(
            jcfg.AssessorConfig.from_json(os.path.join(d, "config.json")))
    # the other decoders dispatch as in JAX: Phi-3 to its own config, Llama
    # and Qwen2 to LLMConfig with their defaults; any other name raises
    for arch in ("Phi3ForCausalLM", "LlamaForCausalLM", "Qwen2ForCausalLM"):
        other = dict(raw, llm_config=dict(raw["llm_config"], architectures=[arch]))
        got, want = tcfg.AssessorConfig.from_dict(other), jcfg.AssessorConfig.from_dict(other)
        assert type(got.llm).__name__ == type(want.llm).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    other = dict(raw, llm_config=dict(raw["llm_config"], architectures=["GPT2LMHeadModel"]))
    for module in (tcfg, jcfg):
        with pytest.raises(ValueError, match="Unsupported architecture"):
            module.AssessorConfig.from_dict(other)


# ------------------------------------------------------- weights from disk --


def test_load_reference_checkpoint_equals_jax_converter(ckpt, tmp_path):
    d, cfg = ckpt
    port_cfg = tcfg.AssessorConfig.from_json(os.path.join(d, "config.json")).replace(
        stage=2, img_context_token_id=cfg.img_context_token_id)
    got = load_reference_checkpoint(d, port_cfg)
    want = state_dict_from_jax(convert(load_torch_state_dict([d]), cfg), port_cfg)
    assert set(got) == set(want) and len(got) == 257
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v.float()), k
    # the JAX tree of the same weights as flax's params.msgpack: read without
    # flax through `model_weights` (a directory holding a JAX tree loads it)
    from flax import serialization

    tree = convert(load_torch_state_dict([d]), cfg)
    (tmp_path / "params.msgpack").write_bytes(serialization.msgpack_serialize(tree))
    args = SimpleNamespace(model_name_or_path=str(tmp_path), seed=0)
    from_tree = t_common.model_weights(args, port_cfg)
    assert set(from_tree) == set(want)
    for k, v in want.items():
        assert torch.equal(from_tree[k], v), k
    with pytest.raises(FileNotFoundError):  # no reference weights beside the tree
        load_reference_checkpoint(str(tmp_path), port_cfg)
    with pytest.raises(FileNotFoundError):
        load_reference_checkpoint(str(tmp_path / "empty_dir_that_is_missing"), port_cfg)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """(JAX model, converted params, port model loaded from the directory)."""
    d, cfg = ckpt
    params = convert(load_torch_state_dict([d]), cfg)
    _, port, _ = t_common.build_serving_stack(d, model_scale="tiny", bf16=False, device="cpu")
    return AIGVAssessor(cfg, Precision.fp32()), params, port


def _prompts(cfg, b, p, seed):
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    ids = rng.integers(5, 300, (b, p, 1 + n_ctx + 12)).astype(np.int32)
    ids[ids == cfg.img_context_token_id] = 5
    ids[:, :, 1 : 1 + n_ctx] = cfg.img_context_token_id
    mask = np.ones(ids.shape, bool)
    mask[:, 1:, -2:] = False
    return ids, mask


@pytest.mark.parametrize("normalize_type", ["imagenet", "clip", "siglip"])
def test_loaded_model_scores_equal_jax(ckpt, loaded, normalize_type):
    _, cfg = ckpt
    model, params, port = loaded
    ids, mask = _prompts(cfg, 2, 2, seed=3)
    u8 = np.random.default_rng(4).integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)
    pv = resize_normalize(jnp.asarray(u8), size=56, normalize_type=normalize_type,
                          dtype=jnp.float32)
    want = model.apply(params, jnp.asarray(ids), pv, jnp.asarray(mask),
                       method="score_perspectives")
    got = t_score.score_batch(port, torch.from_numpy(ids).long(), torch.from_numpy(u8),
                              torch.from_numpy(mask), normalize_type=normalize_type)
    assert tuple(got.shape) == (2, 2) and got.abs().max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # float frames are taken as already normalized
    again = t_score.score_batch(port, torch.from_numpy(ids).long(),
                                torch.from_numpy(np.array(pv)), torch.from_numpy(mask))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


# --------------------------------------------------------------------- CLI --

CLI_CASES = {
    # name: (questions, checkpoint, extra flags)
    "one_question_seed": (1, False, []),
    "two_questions_ckpt": (2, True, []),
    "two_questions_seed_w8a8": (2, False, ["--w8a8", "True"]),
    "one_question_ckpt_host_preprocess": (1, True, ["--device_preprocess", "False",
                                                    "--normalize_type", "clip"]),
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_score_cli(media, ckpt, tmp_path, capsys, name):
    d, _ = media
    n_q, with_ckpt, extra = CLI_CASES[name]
    out = tmp_path / "scores.csv"
    argv = ["--videos", d, "--model_scale", "tiny", "--device", "cpu", "--bf16", "False",
            "--num_segments", str(T), "--batch_size", "3", "--workers", "2", "--out", str(out),
            *[a for q in QUESTIONS[:n_q] for a in ("--question", q)], *extra]
    if with_ckpt:
        argv += ["--model_name_or_path", ckpt[0]]
    env = {**os.environ, "AIGV_FUSE_QUANT": "vit,llm", "AIGV_QUANT_ROWS": "vit,llm"}
    fed = []  # the decoded videos the CLI hands to score_chunks, in order
    real_score_chunks = t_score.score_chunks

    def spy(model, chunks, *a, **kw):
        def tee():
            for chunk in chunks:
                fed.extend(chunk)
                yield chunk
        return real_score_chunks(model, tee(), *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", env)
        mp.setattr(t_score, "score_chunks", spy)
        rows = t_score.main(argv)
        config, model, tok = t_common.build_serving_stack(
            ckpt[0] if with_ckpt else "", model_scale="tiny", bf16=False, device="cpu",
            w8a8="--w8a8" in extra)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == SUMMARY_KEYS and summary["n_videos"] == 4
    assert summary["n_perspectives"] == n_q and summary["out"] == str(out)
    with open(out) as f:
        table = list(csv.reader(f))
    header = ["video_name", "pred_score"] if n_q == 1 else \
        ["video_name"] + [f"pred_score_{i + 1}" for i in range(n_q)]
    assert table[0] == header
    videos = t_score.list_videos(d)
    assert [r[0] for r in table[1:]] == videos and len(rows) == 4
    scores = np.array([[float(v) for v in r[1:]] for r in table[1:]])
    assert scores.shape == (4, n_q) and np.isfinite(scores).all()
    if "--w8a8" in extra:
        assert model.precision.fuse_quant == model.precision.quant_rows == {"vit", "llm"}

    # the same scores from score_chunks on the same decoded frames
    host = "--device_preprocess" in extra
    prompts = [t_score.build_prompt_ids(tok, config.template, q, T, config.num_image_token)
               for q in QUESTIONS[:n_q]]
    n = max(len(p) for p in prompts)
    ids_pn = np.full((n_q, n), tok.pad_token_id, np.int64)
    mask_pn = np.zeros((n_q, n), bool)
    for i, p in enumerate(prompts):
        ids_pn[i, : len(p)], mask_pn[i, : len(p)] = p, True
    frames = [t_video.load_video(v, num_segments=T, out_size=56) for v in videos]
    # on the host path the frames are normalized with the ImageNet statistics
    # whatever --normalize_type says, as JAX's CLI does
    # (aigv_assessor_tpu/cli/score.py:219)
    decoded = [t_video.transform_frames(f, 56) if host
               else t_video.frames_to_uint8(f, 56) for f in frames]
    assert len(fed) == len(videos)
    for got, f, want in zip(fed, frames, decoded):
        if host:
            np.testing.assert_allclose(got, j_video.transform_frames(f, 56), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got, want)
    want = t_score.score_chunks(model, [decoded[:3], decoded[3:]], ids_pn, mask_pn,
                                batch_size=3)
    np.testing.assert_allclose(scores, np.asarray(want), rtol=1e-6, atol=1e-6)
