"""The decoders `LLMConfig` maps onto InternLM2's, against the JAX package on
the CPU: Qwen2 (InternVL2-1B's Qwen2-0.5B: biased q/k/v, a bias-free o,
tied embeddings, no rope scaling) and Llama (`attention_bias`), the
four-way `AssessorConfig` dispatch, and `InternLM2ForSequenceClassification`.

One JAX tree per model, made from a seed, goes through
`models/loading.state_dict_from_jax` into the port; inputs come from numpy;
both sides run in fp32. The tiny Qwen2 decoder keeps Qwen2-0.5B's grouping
of 14 query heads on 2 kv heads (head dim 8). Tolerances as
tests/test_torch_models.py and tests/test_torch_fused_feeds.py hold them:
2e-4 for the float forward, logits, cached steps, int8 / int4 and the
classifier; 2e-3 for W8A8 logits (tests/test_torch_decode.py's W8A8 bound: a
last-bit difference can flip an int8 value); configs and weights exactly.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core import config as tcfg_mod
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import (
    InternLM2ForSequenceClassification as TorchSeqCls,
)
from aigv_assessor_torch.models import generation as t_gen
from aigv_assessor_torch.models.internlm2 import KVCache as TorchKVCache
from aigv_assessor_torch.models.loading import (
    flatten_tree,
    jax_tree,
    load_reference_checkpoint,
    quantize_for_serving,
    renamed_state,
    state_dict_from_jax,
)
from aigv_assessor_tpu.core import config as jcfg_mod
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models import generation as j_gen
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.internlm2 import InternLM2ForSequenceClassification, KVCache
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.tools.convert_weights import convert, load_torch_state_dict

from tests._torch_decoder_fixtures import jax_gates, write_reference_checkpoint

TOL = 2e-4
W8A8_TOL = 2e-3
CTX = 7
T = 4
TEXT = 16
# Qwen2-0.5B-Instruct's config.json fields, at a tiny width with its grouping
QWEN2 = {"architectures": ["Qwen2ForCausalLM"], "vocab_size": 512, "hidden_size": 112,
         "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 14,
         "num_key_value_heads": 2, "max_position_embeddings": 4096, "rms_norm_eps": 1e-6,
         "rope_theta": 1000000.0, "tie_word_embeddings": True, "bos_token_id": 151643,
         "eos_token_id": 151645, "hidden_act": "silu", "rope_scaling": None,
         "use_sliding_window": False}
LLAMA = {"architectures": ["LlamaForCausalLM"], "vocab_size": 512, "hidden_size": 64,
         "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
         "rope_theta": 10000.0, "attention_bias": True}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _pair(llm_dict):
    """(JAX config, JAX fp32 params, port config, port fp32 model) of the
    tiny stage-2 model with the decoder `llm_dict` describes."""
    cfg = AssessorConfig.tiny(stage=2).replace(
        img_context_token_id=CTX, llm=jcfg_mod.LLMConfig.from_dict(llm_dict))
    tcfg = TorchConfig.tiny(stage=2).replace(
        img_context_token_id=CTX, llm=tcfg_mod.LLMConfig.from_dict(llm_dict))
    model = AIGVAssessor(cfg, Precision.fp32())
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(np.random.default_rng(0).integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return cfg, params, tcfg, port.eval()


@pytest.fixture(scope="module")
def qwen2():
    return _pair(QWEN2)


def _embeds(seed, b, s, c):
    return np.random.default_rng(seed).normal(size=(b, s, c)).astype(np.float32)


# --------------------------------------------------------------- dispatch --


@pytest.mark.parametrize("llm", [
    {"architectures": ["InternLM2ForCausalLM"], "bias": False,
     "rope_scaling": {"type": "dynamic", "factor": 2.0}},
    {},  # no architecture: InternLM2
    QWEN2,
    dict(QWEN2, rope_scaling={"type": "linear", "factor": 4.0}, tie_word_embeddings=False),
    dict(QWEN2, qkv_bias=False),  # an explicit field wins over Qwen2's default
    LLAMA,
    dict(LLAMA, attention_bias=False, rope_scaling=None),
    {"architectures": ["LlamaForCausalLM"]},
    {"architectures": ["Phi3ForCausalLM"], "hidden_size": 3072,
     "rope_scaling": {"type": "longrope", "short_factor": [1.0], "long_factor": [2.0]}},
], ids=["internlm2", "default", "qwen2", "qwen2_linear_untied", "qwen2_explicit",
        "llama_bias", "llama_plain", "llama_defaults", "phi3"])
def test_assessor_config_dispatch_matches_jax_field_for_field(llm):
    d = {"vision_config": {"hidden_size": 32}, "llm_config": llm, "downsample_ratio": 0.5,
         "template": "phi3-chat"}
    got, want = TorchConfig.from_dict(json.loads(json.dumps(d))), AssessorConfig.from_dict(d)
    assert type(got.llm).__name__ == type(want.llm).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if type(got.llm).__name__ == "LLMConfig":
        assert (got.llm.effective_qkv_bias, got.llm.effective_o_bias) == (
            want.llm.effective_qkv_bias, want.llm.effective_o_bias)


def test_unknown_architecture_raises_as_in_jax():
    d = {"llm_config": {"architectures": ["GPT2LMHeadModel"]}}
    for cls in (TorchConfig, AssessorConfig):
        with pytest.raises(ValueError, match="Unsupported architecture: GPT2LMHeadModel"):
            cls.from_dict(d)


# ----------------------------------------------------- Qwen2: tied, biased --


def test_qwen2_modules_are_tied_and_biased(qwen2):
    _, params, _, port = qwen2
    lm = port.language_model
    assert lm.output is None and "output" not in params["params"]["language_model"]
    attn = lm.layers[0].attention
    assert attn.wqkv.bias is not None and attn.wo.bias is None
    assert tuple(attn.wqkv.weight.shape) == ((14 + 2 * 2) * 8, 112)


def test_qwen2_hidden_and_tied_logits_match(qwen2):
    cfg, params, _, port = qwen2
    model = AIGVAssessor(cfg, Precision.fp32())
    embeds = _embeds(2, 2, 40, 112)
    want = model.apply(params, jnp.asarray(embeds),
                       method=lambda m, e: m.language_model(inputs_embeds=e)[:2])
    with torch.no_grad():
        got = port.language_model(inputs_embeds=_t(embeds))[:2]
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (2, 40, 512)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # the logits are the hidden state times the embedding matrix
    emb = port.language_model.tok_embeddings.weight
    torch.testing.assert_close(got[0], got[1] @ emb.T, rtol=0, atol=0)


def test_qwen2_prefill_decode_and_score_match(qwen2):
    cfg, params, tcfg, port = qwen2
    model = AIGVAssessor(cfg, Precision.fp32())
    b, prompt, steps, cap = 2, 20, 3, 32
    ids = np.random.default_rng(6).integers(5, 500, (b, prompt + steps))
    cache = KVCache.init(cfg.llm, b, cap, dtype=jnp.float32)
    embeds = model.apply(params, jnp.asarray(ids[:, :prompt]), method="embed_tokens")
    logits, _, cache = model.apply(params, embeds, cache, method="prefill")
    want = [logits]
    for i in range(prompt, prompt + steps):
        logits, _, cache = model.apply(params, jnp.asarray(ids[:, i : i + 1]), cache,
                                       method="decode_step")
        want.append(logits)
    tcache = TorchKVCache.init(tcfg.llm, b, cap, dtype=torch.float32)
    with torch.no_grad():
        logits, _, tcache = port.prefill(port.embed_tokens(_t(ids[:, :prompt]).long()), tcache)
        got = [logits]
        for i in range(prompt, prompt + steps):
            logits, _, tcache = port.decode_step(_t(ids[:, i : i + 1]).long(), tcache)
            got.append(logits)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"logits, step {step}")

    n_ctx = T * cfg.num_image_token + 1
    ids = np.random.default_rng(4).integers(10, 500, (2, n_ctx + TEXT)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones(ids.shape, bool)
    mask[1, -3:] = False
    px = np.random.default_rng(5).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       with_logits=True)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask), with_logits=True)
    for key in ("hidden", "logits", "readout" if "readout" in want else "score"):
        _close(got[key], want[key])


def test_qwen2_greedy_generation_matches_jax(qwen2):
    """`generate` through the tied head with the motion token, greedy: the
    token ids of both packages."""
    cfg, params, _, port = qwen2
    model = AIGVAssessor(cfg, Precision.fp32())
    n_ctx = T * cfg.num_image_token + 1
    ids = np.random.default_rng(9).integers(10, 500, (2, n_ctx + 8)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    px = np.random.default_rng(10).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    want = j_gen.generate(model, params, None, ids, px, with_motion=True,
                          gcfg=j_gen.GenerationConfig(max_new_tokens=5, eos_token_id=-1))
    got = t_gen.generate(port, None, ids, px, with_motion=True,
                         gcfg=t_gen.GenerationConfig(max_new_tokens=5, eos_token_id=-1))
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["w8a8", "int8", "int4"])
def test_tied_logits_in_every_precision(qwen2, mode):
    """The embedding is never quantized: in W8A8 and weight-only modes the
    tied logits still read it, as JAX's `Embed.attend` does."""
    cfg, params, tcfg, _ = qwen2
    qparams, prec = jax_quantize_for_serving(params, Precision.fp32(), **{mode: True})
    qparams = jax.device_get(qparams)
    tprec = dict(w8a8=TorchPrecision(compute_dtype=torch.float32, w8a8=True,
                                     fuse_quant=(), quant_rows=()),
                 int8=TorchPrecision(compute_dtype=torch.float32, int8_weights=True),
                 int4=TorchPrecision(compute_dtype=torch.float32, int4_weights=True))[mode]
    port = TorchAssessor(tcfg, tprec)
    state = state_dict_from_jax(qparams, tcfg, tprec)
    port.load_state_dict(state, strict=True)
    own = quantize_for_serving(state_dict_from_jax(params, tcfg), tcfg,
                               int8=mode == "int8", int4=mode == "int4")
    assert set(own) == set(state) and all(torch.equal(own[k], state[k]) for k in state)
    assert port.language_model.output is None
    assert port.language_model.tok_embeddings.weight.dtype == torch.float32
    model = AIGVAssessor(cfg, prec)
    embeds = _embeds(3, 2, 24, 112)
    with jax_gates("0"):
        want = model.apply(qparams, jnp.asarray(embeds),
                           method=lambda m, e: m.language_model(inputs_embeds=e)[0])
    with torch.no_grad():
        got = port.eval().language_model(inputs_embeds=_t(embeds))[0]
    _close(got, want, W8A8_TOL if mode == "w8a8" else TOL)


def test_llama_with_attention_bias_matches():
    """Llama with `attention_bias`: q/k/v and o biased, an untied head."""
    cfg, params, _, port = _pair(LLAMA)
    assert port.language_model.layers[0].attention.wo.bias is not None
    assert port.language_model.output is not None
    model = AIGVAssessor(cfg, Precision.fp32())
    embeds = _embeds(7, 2, 30, 64)
    want = model.apply(params, jnp.asarray(embeds),
                       method=lambda m, e: m.language_model(inputs_embeds=e)[:2])
    with torch.no_grad():
        got = port.language_model(inputs_embeds=_t(embeds))[:2]
    _close(got[0], want[0])
    _close(got[1], want[1])


# ---------------------------------------------------- weights, both ways --


def test_hf_named_qwen2_checkpoint_loads_as_jax_converts_it(tmp_path):
    """A reference checkpoint whose decoder has HF Qwen2's names (q/k/v/o,
    gate/up/down, q/k/v biases, no lm_head; 64 wide to match the other
    towers of the synthetic checkpoint) and whose config.json is Qwen2's:
    the config as JAX reads it, the weights as JAX's converter maps them,
    q | k | v fused in that order; an lm_head stored beside the tied
    embedding is left out."""
    hf_config = dict(QWEN2, hidden_size=64, num_attention_heads=8)
    rng = np.random.default_rng(12)
    q, kv, c, f = 8 * 8, 2 * 8, 64, 128
    shapes = {"self_attn.q_proj.weight": (q, c), "self_attn.k_proj.weight": (kv, c),
              "self_attn.v_proj.weight": (kv, c), "self_attn.q_proj.bias": (q,),
              "self_attn.k_proj.bias": (kv,), "self_attn.v_proj.bias": (kv,),
              "self_attn.o_proj.weight": (c, q), "mlp.gate_proj.weight": (f, c),
              "mlp.up_proj.weight": (f, c), "mlp.down_proj.weight": (c, f),
              "input_layernorm.weight": (c,), "post_attention_layernorm.weight": (c,)}
    llm = {f"language_model.model.layers.{i}.{k}": rng.normal(size=v).astype(np.float32)
           for i in range(2) for k, v in shapes.items()}
    llm["language_model.model.embed_tokens.weight"] = rng.normal(size=(512, c)).astype(
        np.float32)
    llm["language_model.model.norm.weight"] = rng.normal(size=(c,)).astype(np.float32)
    d = write_reference_checkpoint(str(tmp_path / "a"), hf_config, llm)
    got_cfg = TorchConfig.from_json(os.path.join(d, "config.json"))
    want_cfg = AssessorConfig.from_json(os.path.join(d, "config.json"))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg.llm.tie_word_embeddings and got_cfg.llm.rope_scaling is None
    got_cfg = got_cfg.replace(stage=2, img_context_token_id=CTX)
    got = load_reference_checkpoint(d, got_cfg)
    want = state_dict_from_jax(convert(load_torch_state_dict([d]), want_cfg), got_cfg)
    assert set(got) == set(want) and "language_model.output.weight" not in got
    for k, v in want.items():
        assert torch.equal(got[k], v.float()), k
    hf = "language_model.model.layers.1.self_attn"
    fused = np.concatenate([llm[f"{hf}.{p}_proj.weight"] for p in "qkv"])
    assert np.array_equal(got["language_model.layers.1.attention.wqkv.weight"].numpy(), fused)
    bias = np.concatenate([llm[f"{hf}.{p}_proj.bias"] for p in "qkv"])
    assert np.array_equal(got["language_model.layers.1.attention.wqkv.bias"].numpy(), bias)
    head = {"language_model.lm_head.weight": llm["language_model.model.embed_tokens.weight"]}
    d2 = write_reference_checkpoint(str(tmp_path / "b"), hf_config, {**llm, **head})
    again = load_reference_checkpoint(d2, got_cfg)
    assert set(again) == set(got) and all(torch.equal(again[k], got[k]) for k in got)


def test_jax_tree_round_trips_tied(qwen2):
    _, params, tcfg, port = qwen2
    got, want = flatten_tree(jax_tree(port)), flatten_tree(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    again = state_dict_from_jax(jax_tree(port), tcfg)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())



# ------------------------------------------------ sequence classification --


def test_sequence_classification_matches():
    """The last non-padding token's hidden state into the bias-free `score`
    layer, rows right-padded by 0, 3 and 7, and without a mask."""
    config = jcfg_mod.LLMConfig.tiny()
    model = InternLM2ForSequenceClassification(config, num_labels=3,
                                               precision=Precision.fp32())
    ids = np.random.default_rng(11).integers(5, 500, (3, 20)).astype(np.int32)
    mask = np.ones(ids.shape, np.int32)
    mask[1, -3:] = 0
    mask[2, -7:] = 0
    params = jax.device_get(model.init(jax.random.key(1), jnp.asarray(ids)))
    port = TorchSeqCls(tcfg_mod.LLMConfig.tiny(), num_labels=3,
                       precision=TorchPrecision.fp32())
    port.load_state_dict(renamed_state(params), strict=True)
    port.eval()
    for m in (mask, None):
        want = model.apply(params, jnp.asarray(ids),
                           attention_mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = port(_t(ids).long(), attention_mask=None if m is None else _t(m))
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3)
        _close(got, want)
