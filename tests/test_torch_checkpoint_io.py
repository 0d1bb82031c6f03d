"""JAX parameter files served by the port as the JAX package serves them, on
the CPU.

One tiny stage-2 tree with rank-2 adapters in both towers (`lora_b` drawn
non-zero, the score head opened), written as flax's `params.msgpack`, runs
through each tool's `main` in both packages, as `tests/test_tools_cli.py`
chains them (merge_lora, convert_to_int8 at 8 and 4 bits and back,
extract_vit, extract_mlp, replace_llm, resize_pos_embed): every output file
byte for byte. The merged tree is then the float checkpoint directory
(`params.msgpack`, `config.json`, `tokenizer.json`), its int8 and int4
conversions the stored quantized ones. Against JAX:

- `build_serving_stack` on the float directory in fp32, bf16, int8, int4 and
  W8A8, and JAX's `load_model_and_tokenizer` on the int8 directory as
  `--int8`, `--int4`, `--w8a8` and float, and on the int4 directory as
  `--int4` and float: every weight of the port's model bit for bit against
  JAX's served tree (`state_dict_from_jax`), so a stored kernel is taken as
  it is stored or through JAX's dequantize-then-quantize; scores at the
  tolerances of `tests/test_torch_cli.py` (fp32, 2e-4),
  `test_torch_weight_only.py` (2e-4) and `test_torch_w8a8.py` (1e-3) in
  fp32 for the float, int8, int4 and W8A8 directories' main modes;
- the same directory written as `params.safetensors`;
- `--vision_path` / `--llm_path` / `--mlp_path` (msgpack and safetensors
  parts from the tools) over another tree and over the seed: the grafted
  weights bit for bit against JAX's `_graft_subcheckpoints`, the rest
  untouched;
- W8A8 with a weight-only mode refused with JAX's text.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import functools
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from aigv_assessor_torch.cli import args as t_args
from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.cli.score import score_batch
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.data.tokenizer import build_test_tokenizer
from aigv_assessor_torch.models.loading import (
    load_jax_params,
    save_jax_params,
    state_dict_from_jax,
)
from aigv_assessor_tpu.cli import common as j_common
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models import loading as j_loading
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.ops.preprocess import resize_normalize
from aigv_assessor_tpu.tools.make_synthetic_ckpt import reference_config_dict

from tests._torch_cli_fixtures import open_tree

TOL = 2e-4  # fp32 and weight-only slices (test_torch_cli.py, test_torch_weight_only.py)
W8A8_SCORE_ATOL = 1e-3  # test_torch_w8a8.py
T = 4


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: directory}: 'lora' (the tree with adapters), 'float' (merged),
    'int8', 'int4' (its conversions), 'other' (a second tree, key 1), each
    with config.json and tokenizer.json; and the tools' outputs under
    'tools', written by both packages."""
    root = tmp_path_factory.mktemp("ckpts")
    tok = build_test_tokenizer()
    cfg = AssessorConfig.tiny(stage=2).replace(
        img_context_token_id=int(tok.img_context_token_id))
    trees = {}
    for name, key, lora in (("lora", 0, 2), ("other", 1, 0)):
        c = cfg.replace(use_backbone_lora=lora, use_llm_lora=lora)
        params = jax.jit(AIGVAssessor(c, Precision.fp32()).init)(
            jax.random.key(key), jnp.zeros((1, 32), jnp.int32), jnp.zeros((1, T, 56, 56, 3)))
        trees[name] = open_tree(jax.device_get(params), lora_b_seed=1 if lora else None)
    out = {}
    for name in ("lora", "float", "int8", "int4", "other"):
        out[name] = root / name
        out[name].mkdir()
        (out[name] / "config.json").write_text(json.dumps(reference_config_dict(cfg)))
        tok._tk.save(str(out[name] / "tokenizer.json"))
    for name, tree in trees.items():
        (out[name] / "params.msgpack").write_bytes(serialization.msgpack_serialize(tree))
    out["tools"] = root / "tools"
    out["tools"].mkdir()
    out["cfg"] = cfg
    return out


def _run_both(tool: str, argv, tools_dir, out_name: str):
    """`main` of the tool in both packages, the output file of each under
    tools/{t,j}_<out_name>; returns the JAX one's path."""
    import importlib

    paths = {}
    for pkg, tag in (("aigv_assessor_torch", "t"), ("aigv_assessor_tpu", "j")):
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        paths[tag] = tools_dir / f"{tag}_{out_name}"
        extra = ["--device", "cpu"] if tool == "merge_lora" and tag == "t" else []
        mod.main(argv(paths[tag]) + extra)
    assert paths["t"].read_bytes() == paths["j"].read_bytes(), tool
    return paths["j"]


@pytest.fixture(scope="module")
def chained(dirs):
    """Each tool's `main` in both packages, chained as test_tools_cli.py
    does; the merged tree and its conversions fill the float / int8 / int4
    directories."""
    tools = dirs["tools"]
    src = str(dirs["lora"] / "params.msgpack")
    merged = _run_both("merge_lora", lambda o: ["--params", src, "--out", str(o)], tools,
                       "merged.msgpack")
    shutil.copy(merged, dirs["float"] / "params.msgpack")
    flt = str(dirs["float"] / "params.msgpack")
    for bits in (8, 4):
        q = _run_both("convert_to_int8", lambda o: ["--params", flt, "--out", str(o), "--bits",
                                                    str(bits)], tools, f"int{bits}.msgpack")
        shutil.copy(q, dirs[f"int{bits}"] / "params.msgpack")
        _run_both("convert_to_int8", lambda o: ["--params", str(q), "--out", str(o),
                                                "--dequantize"], tools, f"deq{bits}.msgpack")
    _run_both("convert_to_int8", lambda o: ["--params", flt, "--out", str(o), "--scope", ""],
              tools, "int8_all.msgpack")
    parts = {
        "vit": _run_both("extract_vit", lambda o: ["--params", flt, "--out", str(o)], tools,
                         "vit.msgpack"),
        "mlp": _run_both("extract_mlp", lambda o: ["--params", flt, "--out", str(o)], tools,
                         "mlp.msgpack"),
        "llm": _run_both("replace_llm", lambda o: ["--params", str(dirs["other"] /
                                                                 "params.msgpack"),
                                                   "--llm_params", flt, "--out", str(o)],
                         tools, "swapped.msgpack"),
    }
    _run_both("resize_pos_embed", lambda o: ["--params", flt, "--old_size", "56", "--new_size",
                                             "84", "--patch", "14", "--out", str(o)], tools,
              "resized.msgpack")
    return parts


def _jax_tree(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _port(path, **kw):
    """The port's serving stack on `path` in fp32 on the CPU."""
    kw.setdefault("bf16", False)
    return t_common.build_serving_stack(str(path), model_scale="tiny", device="cpu", **kw)


def _assert_weights_equal(model, jax_params, tcfg, precision):
    want = state_dict_from_jax(jax_params, tcfg, precision)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        assert torch.equal(got[k], v), k


def _prompts(cfg, seed=3):
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    ids = rng.integers(5, 300, (2, 2, 1 + n_ctx + 12)).astype(np.int32)
    ids[ids == cfg.img_context_token_id] = 5
    ids[:, :, 1:1 + n_ctx] = cfg.img_context_token_id
    mask = np.ones(ids.shape, bool)
    mask[:, 1:, -2:] = False
    u8 = np.random.default_rng(seed + 1).integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)
    return ids, mask, u8


def _assert_scores_close(jmodel, jparams, port, cfg, tol):
    ids, mask, u8 = _prompts(cfg)
    pv = resize_normalize(jnp.asarray(u8), size=56, dtype=jnp.float32)
    want = jax.jit(functools.partial(jmodel.apply, method="score_perspectives"))(
        jparams, jnp.asarray(ids), pv, jnp.asarray(mask))
    got = score_batch(port, torch.from_numpy(ids).long(), torch.from_numpy(u8),
                      torch.from_numpy(mask))
    assert tuple(got.shape) == (2, 2) and got.abs().max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


# (directory, port flags, JAX reference: "stack" = build_serving_stack, "load" =
# load_model_and_tokenizer, score tolerance or None for weights only)
MODES = {
    "float_fp32": ("float", {}, "stack", TOL),
    "float_bf16": ("float", {"bf16": True}, "stack", None),
    "float_int8": ("float", {"int8": True}, "stack", None),
    "float_int4": ("float", {"int4": True}, "stack", None),
    "float_w8a8": ("float", {"w8a8": True}, "stack", None),
    "int8_file_int8": ("int8", {"int8": True}, "load", TOL),
    "int8_file_int4": ("int8", {"int4": True}, "load", None),
    "int8_file_w8a8": ("int8", {"w8a8": True}, "load", W8A8_SCORE_ATOL),
    "int8_file_float": ("int8", {}, "load", None),
    "int4_file_int4": ("int4", {"int4": True}, "load", TOL),
    "int4_file_float": ("int4", {}, "load", None),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_served_like_jax(dirs, chained, mode):
    name, flags, ref, tol = MODES[mode]
    d = dirs[name]
    flags = dict(flags)
    bf16 = flags.pop("bf16", False)
    if ref == "stack":
        jcfg, jmodel, jparams, _ = j_common.build_serving_stack(
            str(d), model_scale="tiny", bf16=bf16, **flags)
    else:
        jcfg, jmodel, jparams, _ = j_loading.load_model_and_tokenizer(
            str(d), precision=Precision.fp32(), **flags)
    cfg, port, _ = _port(d, bf16=bf16, **flags)
    assert cfg.img_context_token_id == jcfg.img_context_token_id
    precision = dataclasses.replace(
        TorchPrecision() if bf16 else TorchPrecision.fp32(),
        w8a8=jmodel.precision.w8a8, int8_weights=jmodel.precision.int8_weights,
        int4_weights=jmodel.precision.int4_weights)
    _assert_weights_equal(port, jparams, cfg, precision)
    if tol is not None:
        _assert_scores_close(jmodel, jparams, port, jcfg, tol)


def test_params_safetensors_equals_msgpack(dirs, chained, tmp_path):
    """The same tree as `params.safetensors` (flat, '/'-joined keys) loads
    the same model; a directory with both takes `params.msgpack`, as JAX."""
    for name in ("float", "int8"):
        d = tmp_path / name
        shutil.copytree(dirs[name], d)
        save_jax_params(str(d / "params.safetensors"), load_jax_params(str(d)))
        _, a, _ = _port(d, int8=True)  # both files: the msgpack one
        os.remove(d / "params.msgpack")
        _, b, _ = _port(d, int8=True)
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _graft_args(base, parts):
    argv = ["--meta_path", "unused.json", "--model_scale", "tiny", "--device", "cpu",
            "--bf16", "False", "--seed", "5", "--model_name_or_path", str(base or "")]
    for flag, path in parts.items():
        argv += [f"--{flag}", str(path)]
    return t_args.parse_args("graft", argv)


def test_grafts_equal_jax(dirs, chained, tmp_path):
    vit_st = tmp_path / "vit.safetensors"
    save_jax_params(str(vit_st), load_jax_params(str(chained["vit"])))
    parts = {"vision_path": chained["vit"], "llm_path": chained["llm"],
             "mlp_path": chained["mlp"]}
    want = j_common._graft_subcheckpoints(
        _jax_tree(dirs["other"] / "params.msgpack"),
        SimpleNamespace(**{k: str(v) for k, v in parts.items()}))
    for vision in (chained["vit"], vit_st):  # the port reads either container
        cfg, model, _ = t_common.build_model_and_tokenizer(
            _graft_args(dirs["other"], dict(parts, vision_path=vision)), stage=2)
        _assert_weights_equal(model, want, cfg, TorchPrecision.fp32())
    # the grafted towers are the float tree's, the rest the other tree's
    flt = state_dict_from_jax(_jax_tree(dirs["float"] / "params.msgpack"), cfg)
    other = state_dict_from_jax(_jax_tree(dirs["other"] / "params.msgpack"), cfg)
    got = model.state_dict()
    grafted = ("vision_model.", "language_model.", "mlp1.", "motion_mlp.")
    for k in got:
        src = flt if k.startswith(grafted) else other
        assert torch.equal(got[k], src[k]), k
    # over the seed: the parts replace the seed's towers, the rest is the seed's
    _, seeded, _ = t_common.build_model_and_tokenizer(_graft_args(None, parts), stage=2)
    _, plain, _ = t_common.build_model_and_tokenizer(_graft_args(None, {}), stage=2)
    s, p = seeded.state_dict(), plain.state_dict()
    for k in s:
        assert torch.equal(s[k], flt[k] if k.startswith(grafted) else p[k]), k


def test_w8a8_with_weight_only_raises_jax_text(dirs, chained):
    with pytest.raises(ValueError, match="--w8a8 excludes --int8/--int4 weight streaming"):
        _port(dirs["int8"], w8a8=True, int8=True)
