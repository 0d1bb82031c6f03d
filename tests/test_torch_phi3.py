"""The Phi-3 decoder (InternVL2-4B's) against the JAX package on the CPU.

One JAX tree of `AssessorConfig.tiny(stage=2)` with `Phi3Config.tiny()` as
its decoder, made from a seed and given su rope scaling with stated factor
tables, goes through `models/loading.state_dict_from_jax` into the port.
`original_max_position_embeddings` is 32, so the 33-token prompts and every
cache take the long factor table and `scale_mult` is live. Inputs come from
numpy; both sides run in fp32, JAX's attention on its XLA path, the port's
kernels' plain versions.

Tolerances, as the InternLM2 slice's tests hold them: 2e-4 for the float
forward, the cached steps and the shared prefix (tests/test_torch_models.py);
1e-3 for W8A8 scores (tests/test_torch_fused_feeds.py's SCORE_ATOL: a
last-bit difference can flip an int8 value); 2e-4 for int8 / int4
(tests/test_torch_weight_only.py); rope tables bit for bit (both build them
in numpy fp32); LoRA gradients 1e-4 relative to each leaf's largest value.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.cli.common import build_serving_model
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import Phi3Config as TorchPhi3Config
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models import generation as t_gen
from aigv_assessor_torch.models.internlm2 import KVCache as TorchKVCache
from aigv_assessor_torch.models.loading import (
    flatten_tree,
    jax_paths,
    jax_tree,
    load_reference_checkpoint,
    quantize_for_serving,
    state_dict_from_jax,
    weights_from_jax,
)
from aigv_assessor_torch.models.lora import Int4Linear, Int8Linear, W8A8Linear
from aigv_assessor_torch.models.phi3 import phi3_rope_tables
from aigv_assessor_torch.train.checkpoint import extract_lora
from aigv_assessor_torch.train.freeze import trainable_names
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models import generation as j_gen
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.internlm2 import KVCache
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.models.phi3 import Phi3Config
from aigv_assessor_tpu.models.phi3 import phi3_rope_tables as jax_phi3_rope_tables
from aigv_assessor_tpu.tools.convert_weights import convert, load_torch_state_dict

from tests._torch_decoder_fixtures import jax_gates, write_reference_checkpoint

TOL = 2e-4
SCORE_ATOL = 1e-3
GRAD_RTOL = 1e-4
CTX = 7
T = 4
TEXT = 16
BOTH = frozenset({"vit", "llm"})
SU = dict(
    rope_scaling_type="su",
    rope_short_factor=tuple(float(f) for f in np.linspace(1.0, 1.1, 8)),
    rope_long_factor=tuple(float(f) for f in np.linspace(1.0, 3.0, 8)),
    original_max_position_embeddings=32,
)
PROJECTIONS = ("self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj", "mlp.down_proj")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _configs(**lora):
    cfg = AssessorConfig.tiny(stage=2).replace(
        img_context_token_id=CTX, llm=dataclasses.replace(Phi3Config.tiny(), **SU), **lora)
    tcfg = TorchConfig.tiny(stage=2).replace(
        img_context_token_id=CTX, llm=dataclasses.replace(TorchPhi3Config.tiny(), **SU), **lora)
    return cfg, tcfg


def _init(cfg):
    """JAX's tree from seed 0, the score head's last layer made positive so
    that its ReLU passes what the layer before lets through."""
    model = AIGVAssessor(cfg, Precision.fp32())
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(np.random.default_rng(0).integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    last = params["params"]["mlpscore"]["fc3"]
    last["kernel"] = np.abs(np.asarray(last["kernel"]))
    return params


@pytest.fixture(scope="module")
def phi():
    """(JAX config, port config, JAX fp32 model, its params, port fp32 model)."""
    cfg, tcfg = _configs()
    params = _init(cfg)
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return cfg, tcfg, AIGVAssessor(cfg, Precision.fp32()), params, port.eval()


def _prompt(b, seed, n_pad=3):
    rng = np.random.default_rng(seed)
    n_ctx = T * 4 + 1  # 56 px frames: 4 tokens each, and the motion slot
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[:, n - n_pad :] = False
    ids[:, n - n_pad :] = 2
    return ids, mask


def _pixels(b, seed):
    return np.random.default_rng(seed).normal(size=(b, T, 56, 56, 3)).astype(np.float32)


def _perspective_prompts(b, p, seed, suffix=9):
    """[B, P, N] ids sharing one token, every context slot and two more
    tokens; perspective j right-padded by j; and the shared length."""
    rng = np.random.default_rng(seed)
    prefix = 1 + T * 4 + 1 + 2
    ids = rng.integers(10, 500, (b, p, prefix + suffix)).astype(np.int32)
    ids[:, :, :prefix] = ids[:, :1, :prefix]
    ids[:, :, 1 : T * 4 + 2] = CTX
    ids[:, :, prefix] = 10 + np.arange(p)
    mask = np.ones(ids.shape, bool)
    for j in range(1, p):
        mask[:, j, -j:] = False
        ids[:, j, -j:] = 2
    return ids, mask, prefix


# ------------------------------------------------------------ rope tables --


@pytest.mark.parametrize("case", [
    dict(seq=20, kw={}),  # no scaling: plain RoPE, scale 1
    dict(seq=20, kw=SU),  # su, short factors, scale_mult from 4096 / 32
    dict(seq=33, kw=SU),  # su, past the original length: long factors
    dict(seq=50, kw=dict(SU, rope_scaling_type="longrope")),
    dict(seq=50, kw=dict(SU, max_position_embeddings=32)),  # scale 1: no scale_mult
    dict(seq=50, kw=dict(SU, rope_long_factor=None)),  # long asked for, none given
], ids=["plain", "su_short", "su_long", "longrope", "scale1", "no_long_table"])
def test_rope_tables_match_jax_bit_for_bit(case):
    kw = case["kw"]
    cos, sin = phi3_rope_tables(dataclasses.replace(TorchPhi3Config.tiny(), **kw), case["seq"])
    w_cos, w_sin = jax_phi3_rope_tables(dataclasses.replace(Phi3Config.tiny(), **kw), case["seq"])
    assert cos.dtype == sin.dtype == torch.float32 and tuple(cos.shape) == (case["seq"], 16)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(w_cos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(w_sin))


def test_config_from_dict_matches_jax():
    d = {"architectures": ["Phi3ForCausalLM"], "hidden_size": 3072, "num_hidden_layers": 32,
         "rope_scaling": {"type": "su", "short_factor": [1.0, 1.05], "long_factor": [1.0, 2.0]},
         "vocab_size": 32064, "unknown_key": 1}
    got, want = TorchPhi3Config.from_dict(d), Phi3Config.from_dict(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim == 96
    assert dataclasses.asdict(TorchPhi3Config.tiny()) == dataclasses.asdict(Phi3Config.tiny())
    assert dataclasses.asdict(TorchPhi3Config()) == dataclasses.asdict(Phi3Config())


# ---------------------------------------------------------------- forward --


def test_decoder_hidden_and_logits_match(phi):
    _, _, model, params, port = phi
    embeds = np.random.default_rng(2).normal(size=(2, 40, 64)).astype(np.float32)
    want = model.apply(params, jnp.asarray(embeds),
                       method=lambda m, e: m.language_model(inputs_embeds=e)[:2])
    with torch.no_grad():
        got = port.language_model(inputs_embeds=_t(embeds))[:2]
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (2, 40, 512)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_prefill_and_decode_steps_match(phi):
    """The row-major branch against a cache (prefill) and single-token steps
    (the decode kernel's plain version here, JAX's two-part attention)."""
    cfg, tcfg, model, params, port = phi
    b, prompt, steps, cap = 2, 30, 3, 40
    ids = np.random.default_rng(6).integers(5, 500, (b, prompt + steps))
    want = []
    cache = KVCache.init(cfg.llm, b, cap, dtype=jnp.float32)
    embeds = model.apply(params, jnp.asarray(ids[:, :prompt]), method="embed_tokens")
    logits, _, cache = model.apply(params, embeds, cache, method="prefill")
    want.append(logits)
    for i in range(prompt, prompt + steps):
        logits, _, cache = model.apply(params, jnp.asarray(ids[:, i : i + 1]), cache,
                                       method="decode_step")
        want.append(logits)
    got = []
    tcache = TorchKVCache.init(tcfg.llm, b, cap, dtype=torch.float32)
    with torch.no_grad():
        logits, _, tcache = port.prefill(port.embed_tokens(_t(ids[:, :prompt]).long()), tcache)
        got.append(logits)
        for i in range(prompt, prompt + steps):
            logits, _, tcache = port.decode_step(_t(ids[:, i : i + 1]).long(), tcache)
            got.append(logits)
    assert tcache.index == prompt + steps
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"logits, step {step}")


def test_greedy_generation_matches_jax(phi):
    """`generate` with the motion token, greedy, never stopping: the token
    ids of both packages (the port's single-token steps on the decode
    kernel's plain version, JAX's on its two-part attention)."""
    _, _, model, params, port = phi
    ids, _ = _prompt(2, 21, n_pad=0)
    px = _pixels(2, 22)
    want = j_gen.generate(model, params, None, ids, px, with_motion=True,
                          gcfg=j_gen.GenerationConfig(max_new_tokens=5, eos_token_id=-1))
    got = t_gen.generate(port, None, ids, px, with_motion=True,
                         gcfg=t_gen.GenerationConfig(max_new_tokens=5, eos_token_id=-1))
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)


def test_stage2_score_and_shared_prefix_match(phi):
    """The teacher-forced stage-2 forward, and P = 3 perspectives with and
    without the shared prefix (its rope tables from the cache's capacity,
    past the original length)."""
    _, _, model, params, port = phi
    ids, mask = _prompt(2, 4)
    px = _pixels(2, 5)
    want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["readout"], np.asarray(want["hidden"])[np.arange(2), mask.sum(1) - 4])
    assert bool((got["score"] > 0).all())
    _close(got["score"], want["score"])

    ids, mask, prefix = _perspective_prompts(2, 3, seed=13)
    px = _pixels(2, 14)
    for shared in (prefix, None):
        want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                           method="score_perspectives", shared_prefix_len=shared)
        with torch.no_grad():
            got = port.score_perspectives(_t(ids).long(), _t(px), _t(mask),
                                          shared_prefix_len=shared)
        assert tuple(got.shape) == (2, 3) and bool((got > 0).all())
        _close(got, want)


# ------------------------------------------------------------- precisions --


def test_w8a8_with_fused_feeds_matches(phi):
    """W8A8 as JAX's `quantize_for_serving` makes it (o_proj and lm_head
    float), under `AIGV_FUSE_QUANT=vit,llm`: the port's own quantization of
    the fp32 weights is JAX's tree, and the forward and shared-prefix scores
    agree."""
    cfg, tcfg, _, params, _ = phi
    qparams, prec = jax_quantize_for_serving(params, Precision.fp32(), w8a8=True)
    qparams = jax.device_get(qparams)
    tprec = TorchPrecision(compute_dtype=torch.float32, w8a8=True, fuse_quant=BOTH,
                           quant_rows=BOTH)
    port = TorchAssessor(tcfg, tprec)
    want_state = state_dict_from_jax(qparams, tcfg, tprec)
    port.load_state_dict(want_state, strict=True)
    port.eval()
    for name in PROJECTIONS:
        layer = port.get_submodule(f"language_model.layers.0.{name}")
        assert isinstance(layer, W8A8Linear) == (name != "self_attn.o_proj"), name
    assert type(port.language_model.lm_head) is torch.nn.Linear
    got_state = quantize_for_serving(state_dict_from_jax(params, tcfg), tcfg)
    assert set(got_state) == set(want_state)
    assert all(torch.equal(got_state[k], want_state[k]) for k in want_state)

    model = AIGVAssessor(cfg, prec)
    ids, mask = _prompt(2, 4)
    px = _pixels(2, 5)
    with jax_gates("vit,llm"):
        want = model.apply(qparams, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                           with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"], SCORE_ATOL)
    ids, mask, prefix = _perspective_prompts(2, 3, seed=13)
    with jax_gates("vit,llm"):
        want = model.apply(qparams, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                           method="score_perspectives", shared_prefix_len=prefix)
    with torch.no_grad():
        got = port.score_perspectives(_t(ids).long(), _t(px), _t(mask), shared_prefix_len=prefix)
    _close(got, want, SCORE_ATOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_weight_only_scores_match_and_logits_refuse_as_in_jax(phi, mode):
    """JAX's int8 / int4 tree (lm_head quantized too) served by the port: the
    four projections keep their stored bits, the float lm_head takes its
    kernel dequantized; scores agree, and logits raise on both sides."""
    cfg, tcfg, _, params, _ = phi
    qparams, prec = jax_quantize_for_serving(params, Precision.fp32(), **{mode: True})
    qparams = jax.device_get(qparams)
    leaf = "kernel_int8" if mode == "int8" else "kernel_int4"
    assert leaf in qparams["params"]["language_model"]["lm_head"]
    port = build_serving_model(tcfg, device="cpu", precision=TorchPrecision.fp32(),
                               weights=weights_from_jax(qparams, tcfg), **{mode: True})
    cls = Int8Linear if mode == "int8" else Int4Linear
    assert all(type(port.get_submodule(f"language_model.layers.1.{n}")) is cls
               for n in PROJECTIONS)
    assert type(port.language_model.lm_head) is torch.nn.Linear
    # the port's own quantization holds the same values
    own = quantize_for_serving(state_dict_from_jax(params, tcfg), tcfg, **{mode: True})
    for k, v in port.state_dict().items():
        if k.startswith("language_model."):
            assert torch.equal(own[k], v), k

    model = AIGVAssessor(cfg, prec)
    ids, mask = _prompt(2, 4)
    px = _pixels(2, 5)
    want = model.apply(qparams, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"])

    with pytest.raises(Exception):  # flax: no `kernel` under lm_head
        model.apply(qparams, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                    with_logits=True)
    with pytest.raises(ValueError, match="JAX package"), torch.no_grad():
        port(_t(ids).long(), _t(px), _t(mask), with_logits=True)


# --------------------------------------------------------------- training --


def test_lora_gradients_match_jax_grad():
    """Stage-2 LoRA on both towers (r = 2, lora_b drawn nonzero): the
    gradient of sum(hidden * R) for every adapter leaf, against jax.grad,
    with and without per-layer recompute."""
    cfg, tcfg = _configs(use_backbone_lora=2, use_llm_lora=2)
    params = _init(cfg)
    rng = np.random.default_rng(3)

    def draw(path, x):
        if getattr(path[-1], "key", None) == "lora_b":
            return (rng.normal(size=x.shape) * 0.05).astype(np.float32)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(draw, params)
    model = AIGVAssessor(cfg, Precision.fp32())
    ids, mask = _prompt(2, 8)
    px = _pixels(2, 9)
    r = rng.normal(size=(2, ids.shape[1], 64)).astype(np.float32)

    def loss(p):
        out = model.apply(p, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                          with_logits=False)
        return jnp.sum(out["hidden"] * r)

    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jax.grad(loss)(params))[0]}
    for remat in (False, True):
        port = TorchAssessor(tcfg, TorchPrecision.fp32(), grad_checkpoint=remat)
        port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
        port.eval()
        for n, p in port.named_parameters():
            p.requires_grad_(n.endswith(("lora_a", "lora_b")))
        (port(_t(ids).long(), _t(px), _t(mask))["hidden"] * _t(r)).sum().backward()
        names = jax_paths(port)
        checked = 0
        for n, p in port.named_parameters():
            if not p.requires_grad:
                continue
            path, layer = names[n]
            want = flat["params/" + path]
            want = want[layer] if layer is not None else want
            scale = max(float(np.abs(want).max()), 1e-6)
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=GRAD_RTOL * scale,
                                       err_msg=n)
            checked += 1
        assert checked == 2 * 2 * (4 + 4)  # two towers x two layers x four projections x A, B
    # the LoRA artifact and the stage-2 trainable set under JAX's names
    lora_paths = {k[len("params/"):] for k in flat if k.endswith(("lora_a", "lora_b"))}
    assert set(extract_lora(port)) == lora_paths
    assert all(v.shape[0] == 2 for v in extract_lora(port).values())  # stacked layers
    trainable = set(trainable_names(port, 2))
    assert trainable == {n for n, _ in port.named_parameters()
                         if n.endswith(("lora_a", "lora_b")) or n.startswith("mlpscore.")}


# ---------------------------------------------------------- weights on disk --


def test_hf_named_phi3_checkpoint_loads_as_jax_converts_it(phi, tmp_path):
    """A reference checkpoint whose decoder has HF Phi-3's names
    (`language_model.model.layers.<i>.self_attn.qkv_proj.weight`, ...,
    `language_model.lm_head.weight`) and whose `config.json` names
    Phi3ForCausalLM with an su `rope_scaling` dict: the config as JAX reads
    it, and `load_reference_checkpoint` equal to JAX's converter, the decoder
    equal to the weights written."""
    cfg, tcfg, _, _, port = phi
    llm = {}
    for name, t in port.state_dict().items():
        if name.startswith("language_model."):
            rest = name[len("language_model."):]
            hf = rest if rest.startswith("lm_head") else "model." + rest
            llm["language_model." + hf] = t.numpy()
    hf_config = {"architectures": ["Phi3ForCausalLM"], **{
        k: v for k, v in dataclasses.asdict(tcfg.llm).items() if not k.startswith("rope_")},
        "rope_theta": tcfg.llm.rope_theta,
        "rope_scaling": {"type": "su", "short_factor": list(SU["rope_short_factor"]),
                         "long_factor": list(SU["rope_long_factor"])}}
    d = write_reference_checkpoint(str(tmp_path), hf_config, llm)
    got_cfg = TorchConfig.from_json(os.path.join(d, "config.json"))
    want_cfg = AssessorConfig.from_json(os.path.join(d, "config.json"))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg.llm == tcfg.llm
    got_cfg = got_cfg.replace(stage=2, img_context_token_id=CTX)
    got = load_reference_checkpoint(d, got_cfg)
    want = state_dict_from_jax(convert(load_torch_state_dict([d]), want_cfg), got_cfg)
    assert set(got) == set(want) and "language_model.lm_head.weight" in got
    state = port.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v.float()), k
        if k.startswith("language_model."):
            assert torch.equal(got[k], state[k]), k


def test_jax_tree_round_trips(phi):
    """`jax_tree` of the fp32 model is JAX's tree leaf for leaf, and
    `state_dict_from_jax` of it is the model's state."""
    _, tcfg, _, params, port = phi
    got = flatten_tree(jax_tree(port))
    want = flatten_tree(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    again = state_dict_from_jax(jax_tree(port), tcfg)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())

