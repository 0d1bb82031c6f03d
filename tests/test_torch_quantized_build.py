"""The quantized builds, tensor by tensor, against the whole-model fp32
path, on the CPU.

`cli/common.build_serving_model` builds a W8A8, int8 or int4 model in its
own precision: each base tensor drawn from the seed (or taken from a float
state_dict) in fp32, in the order of the float model's `named_parameters`,
and quantized straight into its int8 weight and scale (in blocks of rows),
or rounded to the compute dtype. The reference is the path that needs the
whole model in fp32: `init_random_` / `init_lora_` on the fp32 float model
(the generator drawn in place, parameter by parameter), then
`models/loading.quantize_for_serving` and a cast to bf16. They must agree
bit for bit: int8 values, fp32 scales, bf16 weights, adapters and buffers,
with the adapters live (eval), without them, and folded into the float
weights by `merge_lora_` (a model to serve without adapters), from a seed
and from weights. Also: the JAX package's `quantize_for_serving` of the
same weights with adapters gives the same int8 tree, the adapters kept
float."""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses

import jax
import pytest
import torch

from aigv_assessor_torch.cli.common import build_serving_model
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import (
    INIT_STD,
    init_lora_,
    init_random_,
    quantize_for_serving,
    state_dict_from_jax,
)
from aigv_assessor_torch.models import lora as t_lora
from aigv_assessor_torch.models.lora import (
    Int4Linear,
    Int8Linear,
    W8A8Linear,
    is_lora_param,
    lora_free_state_dict,
    merge_lora_,
)
from aigv_assessor_torch.ops.norms import LayerNorm, RMSNorm
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving

CTX = 7
SEED = 3
MODES = ("w8a8", "int8", "int4")
LORA = dict(use_backbone_lora=2, use_llm_lora=2)


def _config(lora: bool, qk: bool = False) -> TorchConfig:
    cfg = TorchConfig.tiny(stage=2, **(LORA if lora else {})).replace(img_context_token_id=CTX)
    if qk:
        cfg = cfg.replace(vision=dataclasses.replace(
            cfg.vision, hidden_size=40, intermediate_size=64, num_attention_heads=5,
            norm_type="rms_norm", qk_normalization=True, qkv_bias=False))
    return cfg


def _fp32_model(cfg) -> TorchAssessor:
    return TorchAssessor(cfg, TorchPrecision.fp32())


def _in_place_draw(model, seed):
    """The whole-model draw: normal(0, INIT_STD) into every fp32 parameter in
    place, in `named_parameters` order, adapters skipped."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not is_lora_param(name):
                p.normal_(0.0, INIT_STD, generator=gen)


def _reference(cfg, mode, weights=None):
    """The whole-fp32 path: the float model in fp32, quantized, loaded into
    the mode's model, cast to bf16."""
    model = _fp32_model(cfg)
    if weights is None:
        init_lora_(init_random_(model, SEED), SEED + 2)
    else:
        model.load_state_dict(weights, strict=True)
    state = quantize_for_serving(model.state_dict(), cfg, int8=mode == "int8",
                                 int4=mode == "int4")
    prec = TorchPrecision(w8a8=mode == "w8a8", int8_weights=mode == "int8",
                          int4_weights=mode == "int4")
    with torch.device("meta"):
        ref = TorchAssessor(cfg, prec)
    ref.load_state_dict(state, strict=True, assign=True)
    return ref.to(torch.bfloat16)


def _merged(cfg, weights):
    """(config without adapters, its weights): the adapters of `weights` (or
    of the seed's draw) folded into the fp32 bases by `merge_lora_`."""
    model = _fp32_model(cfg)
    if weights is None:
        init_lora_(init_random_(model, SEED), SEED + 2)
    else:
        model.load_state_dict(weights, strict=True)
    return (cfg.replace(use_backbone_lora=0, use_llm_lora=0),
            lora_free_state_dict(merge_lora_(model)))


def _weights(cfg):
    """A float state_dict with every adapter's lora_b non-zero."""
    model = _fp32_model(cfg)
    init_lora_(init_random_(model, 11), 12)
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    return model.state_dict()


def _assert_same(got, want):
    got, want = got.state_dict(), want.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_init_random_draws_what_the_in_place_draw_draws():
    """`init_random_`, drawing each tensor into a fresh fp32 tensor, gives an
    fp32 model the values of the in-place draw over `named_parameters`."""
    cfg = _config(lora=True)
    want, got = _fp32_model(cfg), _fp32_model(cfg)
    _in_place_draw(want, SEED)
    init_random_(got, SEED)
    fixed = (LayerNorm, RMSNorm, torch.nn.LayerNorm)  # filled after the draw, as ls1 / ls2
    checked = 0
    for (name, p), q in zip(want.named_parameters(), got.parameters()):
        module = want.get_submodule(name.rsplit(".", 1)[0])
        if not (is_lora_param(name) or isinstance(module, fixed)
                or name.endswith(("ls1", "ls2"))):
            assert torch.equal(p, q), name
            checked += 1
    assert checked > 50


@pytest.mark.parametrize("source", ["seed", "weights"])
@pytest.mark.parametrize("adapters", ["live", "merged", "none"])
@pytest.mark.parametrize("mode", MODES)
def test_streamed_build_equals_the_whole_fp32_build(mode, adapters, source):
    cfg = _config(lora=adapters != "none")
    weights = _weights(cfg) if source == "weights" else None
    if adapters == "merged":
        cfg, weights = _merged(cfg, weights)
    model = build_serving_model(cfg, device="cpu", seed=SEED, weights=weights, **{mode: True})
    _assert_same(model, _reference(cfg, mode, weights))
    lora = [k for k in model.state_dict() if is_lora_param(k)]
    assert bool(lora) == (adapters == "live")
    assert all(model.state_dict()[k].dtype == torch.bfloat16 for k in lora)


@pytest.mark.parametrize("layer", [W8A8Linear, Int8Linear, Int4Linear])
def test_row_blocks_quantize_as_one_call(layer, monkeypatch):
    """`load_float_weight_` quantizes QUANT_BLOCK values of whole rows at a
    time; at two and a half rows' worth (blocks of two rows, the last of
    one) the bits equal one call of the quantizer on the whole weight."""
    out, inp = 7, 9
    w = torch.randn(out, inp, generator=torch.Generator().manual_seed(5))
    q, s = layer.quantize(w)
    monkeypatch.setattr(t_lora, "QUANT_BLOCK", 5 * inp // 2)
    got = layer(inp, out)
    got.load_float_weight_(w)
    assert torch.equal(got.weight, q) and torch.equal(got.weight_scale, s)


@pytest.mark.parametrize("mode", MODES)
def test_streamed_build_of_the_qk_normalized_tower(mode):
    """InternViT-6B's layer: W8A8 quantizes its dense qkv and proj, the
    weight-only modes leave the tower float; the same bits as the whole-fp32
    path."""
    cfg = _config(lora=True, qk=True)
    model = build_serving_model(cfg, device="cpu", seed=SEED, **{mode: True})
    _assert_same(model, _reference(cfg, mode))
    vit = model.state_dict()["vision_model.layers.0.attn.qkv.weight"]
    assert vit.dtype == (torch.int8 if mode == "w8a8" else torch.bfloat16)


def test_port_quantization_of_adapted_weights_equals_jax():
    """JAX's `quantize_for_serving` of a tree with adapters quantizes the
    bases (`only_base=True`) and keeps the adapters fp32; the port's gives
    the same tree, mapped."""
    lora = dict(use_backbone_lora=2, use_llm_lora=2)
    cfg = AssessorConfig.tiny(stage=2, **lora).replace(img_context_token_id=CTX)
    tcfg = _config(lora=True)
    model = AIGVAssessor(cfg, Precision.fp32())
    n = 4 * cfg.num_image_token + 1 + 16
    ids = jax.numpy.zeros((1, n), jax.numpy.int32)
    px = jax.numpy.zeros((1, 4, 56, 56, 3), jax.numpy.float32)
    host = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    for mode in MODES:
        qparams, _ = jax_quantize_for_serving(host, Precision.fp32(), **{mode: True})
        prec = TorchPrecision(compute_dtype=torch.float32, w8a8=mode == "w8a8",
                              int8_weights=mode == "int8", int4_weights=mode == "int4")
        want = state_dict_from_jax(qparams, tcfg, prec)
        got = quantize_for_serving(state_dict_from_jax(host, tcfg), tcfg,
                                   int8=mode == "int8", int4=mode == "int4")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (mode, k)
        assert all(want[k].dtype == torch.float32 for k in want if is_lora_param(k))
