"""The port's weight-only serving path (W8A16, W4A16) against the JAX package.

Inputs are made with numpy and go through both packages on the CPU in fp32:

- the host-side quantizers (`ops/int8_matmul.py`) against
  `ops/int8_matmul.quantize_weight` and `tools/convert_to_int8.py`: int8
  bytes and packed nibbles exactly (the port stores them transposed, one row
  per output channel), scales to 1e-7;
- the plain versions of the matmul kernels (what the wrappers run on CPU
  tensors) against the Pallas kernels in interpret mode and against the XLA
  branch of `int8_dense_apply` / `int4_dense_apply`, at 1e-5 relative to the
  output's scale: the same sums in another order;
- `quantize_for_serving(int8= | int4=)` against the leaves `quantize_tree*`
  pick, and the JAX quantized trees through `state_dict_from_jax` with
  `strict=True`;
- the tiny InternLM2 and the whole tiny assessor (`score_batch`) under
  `int8_weights` and `int4_weights` against the JAX model on the same
  quantized tree at 2e-4, the tolerance of the fp32 slice
  (tests/test_torch_models.py). Both run the row-major decoder branch; with
  D = 16 attention is the plain version on both sides.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aigv_assessor_torch.cli.score import build_serving_model, score_batch
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import LoRAConfig as TorchLoRAConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import InternLM2ForCausalLM as TorchLM
from aigv_assessor_torch.models.loading import jax_paths, quantize_for_serving, state_dict_from_jax
from aigv_assessor_torch.models.lora import Int4Linear, Int8Linear
from aigv_assessor_torch.ops import int8_matmul as two
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.ops import int8_matmul as jwo
from aigv_assessor_tpu.ops.preprocess import resize_normalize
from aigv_assessor_tpu.tools import convert_to_int8 as c8

SCALE_TOL = 1e-7  # quantization scales
OP_TOL = 1e-5  # one matmul, relative to the largest output
TOL = 2e-4  # the slice
CTX, T, TEXT = 7, 4, 16


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _weights(seed, k, n):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)  # JAX [in, out]
    w[:, 3] = 0.0  # an all-zero output channel takes scale 1.0
    return w


def _close_op(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OP_TOL * np.abs(want).max())


# ------------------------------------------------------------- quantizers ---


def test_quantize_weight_matches_jax():
    w = _weights(0, 48, 24)
    q_j, s_j = jwo.quantize_weight(jnp.asarray(w))
    q, s = two.quantize_weight(_t(w.T))  # the port stores [out, in]
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s[3] == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j).T)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=SCALE_TOL, atol=0)
    np.testing.assert_array_equal(
        two.dequantize_kernel(q, s).numpy(), c8.dequantize_kernel(np.asarray(q_j), s.numpy()).T)


@pytest.mark.parametrize("k", [64, 33], ids=["even_k", "odd_k"])
def test_int4_quantizers_match_numpy(k):
    """Byte j of an output channel packs weight rows 2j (low nibble) and
    2j + 1 (high nibble); an odd K pads a zero nibble; scale absmax / 7."""
    w = _weights(1, k, 16)
    p_np, s_np = c8.quantize_kernel_int4(w)
    p, s = two.quantize_kernel_int4(_t(w.T))
    assert p.dtype == torch.int8 and tuple(p.shape) == (16, (k + 1) // 2) and s[3] == 1.0
    np.testing.assert_array_equal(p.numpy(), p_np.T)
    np.testing.assert_allclose(s.numpy(), s_np, rtol=SCALE_TOL, atol=0)
    unpacked = two.unpack_int4(p, k)
    assert unpacked.dtype == torch.int8 and unpacked.abs().max() <= 7
    np.testing.assert_array_equal(
        unpacked.numpy(), np.round(c8.dequantize_kernel_int4(p_np, np.ones_like(s_np), k)).T)
    np.testing.assert_array_equal(
        two.dequantize_kernel_int4(p, s, k).numpy(), c8.dequantize_kernel_int4(p_np, s_np, k).T)


def test_unpack_int4_sign_extends_every_nibble():
    """All 256 bytes, the -8 that the quantizer never writes included."""
    packed = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)[None]
    got = two.unpack_int4(packed, 512).numpy().reshape(256, 2)
    want = np.asarray(c8.dequantize_kernel_int4(packed.numpy().T, np.ones(1, np.float32), 512))
    np.testing.assert_array_equal(got, want.reshape(256, 2))


# ---------------------------------------------------------- plain matmuls ---


@pytest.mark.parametrize("m", [1, 7, 64])
def test_plain_int8_matmul_matches_pallas_interpret(m):
    rng = np.random.default_rng(0)
    k, n = 256, 512
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, scale = jwo.quantize_weight(jnp.asarray(rng.normal(size=(k, n)), jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = jwo.int8_matmul(jnp.asarray(x), q, scale, out_dtype=jnp.float32)
    got = two.int8_matmul(_t(x), _t(np.asarray(q).T), _t(np.asarray(scale)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _close_op(got, want)


def test_plain_int8_matmul_matches_pallas_interpret_ragged_n():
    """N = 300 against 128-wide blocks: the JAX wrapper pads, the port's
    kernel masks; the plain version has no edge."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    q, scale = jwo.quantize_weight(jnp.asarray(rng.normal(size=(64, 300)), jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = jwo.int8_matmul(jnp.asarray(x), q, scale, block_n=128, block_k=64,
                               out_dtype=jnp.float32)
    _close_op(two.plain_int8_matmul(_t(x), _t(np.asarray(q).T), _t(np.asarray(scale))), want)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_dense_apply_matches_jax_xla_branch(bits):
    """Leading dims, and JAX's `x @ (q * scale)` order of the same sum."""
    rng = np.random.default_rng(1)
    k, n = 96, 160
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    w = _weights(2, k, n)
    if bits == 8:
        q, scale = c8.quantize_kernel(w)
        want = jwo.int8_dense_apply(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                    out_dtype=jnp.float32)
        got = two.int8_dense_apply(_t(x), _t(q.T), _t(scale))
    else:
        q, scale = c8.quantize_kernel_int4(w)
        want = jwo.int4_dense_apply(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                    out_dtype=jnp.float32)
        got = two.int4_dense_apply(_t(x), _t(q.T), _t(scale))
    assert tuple(got.shape) == (2, 3, n)
    _close_op(got, want)
    assert not got[..., 3].any()  # the all-zero channel


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (16, 130, 256), (1, 128, 384), (5, 33, 128)],
                         ids=["8x64x128", "16x130x256", "1x128x384", "odd_k"])
def test_plain_int4_matmul_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed, scale = c8.quantize_kernel_int4(w)
    want = jwo.int4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), block_k=64,
                           out_dtype=jnp.float32, interpret=True)
    got = two.int4_matmul(_t(x), _t(packed.T), _t(scale))
    _close_op(got, want)


def test_plain_matmuls_add_the_bias_and_cast_once():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    q, scale = c8.quantize_kernel(_weights(4, 32, 8))
    bias = rng.normal(size=8).astype(np.float32)
    got = two.plain_int8_matmul(_t(x), _t(q.T), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), (x @ q.astype(np.float32)) * scale + bias,
                               rtol=1e-5, atol=1e-5)
    # bf16 in: products of the bf16 values in fp32, one rounding at the end
    xb = _t(x).to(torch.bfloat16)
    got = two.plain_int8_matmul(xb, _t(q.T), _t(scale), _t(bias).to(torch.bfloat16))
    want = (xb.float() @ _t(q.T).float().t()) * _t(scale) + _t(bias).to(torch.bfloat16).float()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))


def test_wrappers_run_plain_on_cpu_without_counting_and_reject():
    x = _t(np.random.default_rng(5).normal(size=(3, 32)).astype(np.float32))
    q, scale = (_t(a) for a in c8.quantize_kernel(_weights(6, 32, 8)))
    q = q.t().contiguous()
    p, s4 = two.quantize_kernel_int4(two.dequantize_kernel(q, scale))
    before = two.int8_matmul.launches, two.int4_matmul.launches
    assert torch.equal(two.int8_matmul(x, q, scale), two.plain_int8_matmul(x, q, scale))
    assert torch.equal(two.int4_matmul(x, p, s4), two.plain_int4_matmul(x, p, s4))
    assert (two.int8_matmul.launches, two.int4_matmul.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        two.int8_matmul(torch.empty((3, 32), device="meta"), q, scale)
    with pytest.raises(ValueError, match="weight"):
        two.int8_matmul(x, q.float(), scale)
    with pytest.raises(ValueError, match="weight"):
        two.int4_matmul(x, q, scale)  # 32 bytes per row where int4 has 16
    with pytest.raises(ValueError, match="scale"):
        two.int8_matmul(x, q, scale[:4])
    with pytest.raises(ValueError, match="bias"):
        two.int8_matmul(x, q, scale, torch.zeros(3))


# ---------------------------------------------------------------- modules ---


def test_linears_keep_their_scale_fp32_under_a_cast():
    for cls, cols in ((Int8Linear, 10), (Int4Linear, 5)):
        m = cls(10, 6, bias=True).to(torch.bfloat16)
        assert m.weight.dtype == torch.int8 and tuple(m.weight.shape) == (6, cols)
        assert m.weight_scale.dtype == torch.float32 and m.bias.dtype == torch.bfloat16
        assert set(m.state_dict()) == {"weight", "weight_scale", "bias"}
    with pytest.raises(ValueError, match="input features"):
        Int4Linear(9, 4)(torch.zeros(2, 10))  # 10 columns would pack into the same 5 bytes


def test_precision_modes_exclude_each_other():
    assert TorchPrecision.int8().int8_weights and TorchPrecision.int8().weight_only
    assert dataclasses.asdict(TorchPrecision.int8())["compute_dtype"] == torch.bfloat16
    for flag in ("int8_weights", "int4_weights"):
        with pytest.raises(ValueError, match="w8a8 excludes"):
            TorchPrecision(w8a8=True, **{flag: True})
    tcfg = TorchConfig.tiny(stage=2)
    with pytest.raises(ValueError, match="w8a8 excludes"):
        build_serving_model(tcfg, device="cpu", w8a8=True, int8=True)


def test_lora_over_a_weight_only_base_is_not_ported():
    tcfg = TorchConfig.tiny(stage=2)
    for flag in ("int8_weights", "int4_weights"):
        with pytest.raises(NotImplementedError, match="weight-only base"):
            TorchLM(tcfg.llm, TorchPrecision(**{flag: True}), lora=TorchLoRAConfig(r=4))


# ------------------------------------------------------------------ slice ---


@pytest.fixture(scope="module")
def host():
    """(JAX fp32 params on the host, JAX config, port config)."""
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    rng = np.random.default_rng(0)
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(rng.integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    return params, cfg, TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)


@pytest.fixture(scope="module", params=["int8", "int4"])
def pair(request, host):
    """(mode, JAX model, its quantized params, port model): one fp32 tree,
    quantized by JAX's `quantize_for_serving` and mapped into the port."""
    params, cfg, tcfg = host
    mode = request.param
    qparams, prec = jax_quantize_for_serving(params, Precision.fp32(), **{mode: True})
    assert getattr(prec, f"{mode}_weights")
    tprec = TorchPrecision(compute_dtype=torch.float32, **{f"{mode}_weights": True})
    port = TorchAssessor(tcfg, tprec)
    port.load_state_dict(state_dict_from_jax(qparams, tcfg, tprec), strict=True)
    return mode, AIGVAssessor(cfg, prec), qparams, port.eval()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _prompt(cfg, b, seed):
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[:, n - 3 :] = False  # right-padded by 3
    ids[:, n - 3 :] = 2
    return ids, mask


def test_quantized_modules_are_the_decoder_and_the_head(pair):
    mode, _, _, port = pair
    cls = Int8Linear if mode == "int8" else Int4Linear
    quantized = {n for n, m in port.named_modules() if hasattr(m, "weight_scale")}
    layers = port.config.llm.num_hidden_layers
    want = {f"language_model.layers.{i}.{m}" for i in range(layers)
            for m in ("attention.wqkv", "attention.wo", "feed_forward.w1", "feed_forward.w2",
                      "feed_forward.w3")} | {"language_model.output"}
    assert quantized == want
    assert all(type(port.get_submodule(n)) is cls for n in quantized)
    # the JAX names of the new leaves, the inverse of state_dict_from_jax
    names = jax_paths(port)
    leaf = "kernel_int8" if mode == "int8" else "kernel_int4"
    scale = "kernel_scale" if mode == "int8" else "kernel_scale4"
    assert names["language_model.output.weight"] == (f"language_model/output/{leaf}", None)
    assert names["language_model.layers.1.attention.wo.weight_scale"] == (
        f"language_model/layers/attention/wo/base/{scale}", 1)


def test_port_quantize_for_serving_equals_jax_tree(pair, host):
    """The port's quantization of the same fp32 weights gives the mapped JAX
    tree exactly: the same leaves picked, the same bytes, dtypes included."""
    mode, _, qparams, port = pair
    params, _, tcfg = host
    got = quantize_for_serving(state_dict_from_jax(params, tcfg), tcfg, **{mode: True})
    want = state_dict_from_jax(qparams, tcfg, port.precision)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert sum(v.dtype == torch.int8 for v in want.values()) == 2 * 5 + 1
    # an int4 tree that still carries its kernel_in_dim scalars loads too
    if mode == "int4":
        unstripped = c8.quantize_tree_int4(params)
        again = state_dict_from_jax(unstripped, tcfg, port.precision)
        assert all(torch.equal(again[k], want[k]) for k in want)


def test_quantize_for_serving_checks_its_inputs(host):
    params, _, tcfg = host
    state = state_dict_from_jax(params, tcfg)
    with pytest.raises(TypeError, match="fp32"):
        quantize_for_serving({k: v.to(torch.bfloat16) for k, v in state.items()}, tcfg,
                             int8=True)


def test_internlm2_hidden_matches(pair):
    _, model, qparams, port = pair
    embeds = np.random.default_rng(2).normal(size=(2, 21, port.config.llm.hidden_size))
    embeds = embeds.astype(np.float32)
    want = model.apply(
        qparams, jnp.asarray(embeds),
        method=lambda m, e: m.language_model(inputs_embeds=e, with_logits=False)[1],
    )
    with torch.no_grad():
        got = port.language_model(inputs_embeds=_t(embeds), with_logits=False)[1]
    _close(got, want)


def test_forward_and_scores_match(pair, host):
    """The slice as a whole: the teacher-forced forward's hidden state and
    score, and uint8 frames through `score_batch`."""
    _, model, qparams, port = pair
    _, cfg, _ = host
    ids, mask = _prompt(cfg, 2, 4)
    px = np.random.default_rng(5).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    want = model.apply(qparams, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"])

    u8 = np.random.default_rng(8).integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)
    pv = resize_normalize(jnp.asarray(u8), size=56, dtype=jnp.float32)
    want = model.apply(qparams, jnp.asarray(ids[:, None]), pv, jnp.asarray(mask[:, None]),
                       method="score_perspectives")
    got = score_batch(port, _t(ids[:, None]).long(), _t(u8), _t(mask[:, None]))
    assert tuple(got.shape) == (2, 1) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_build_serving_model_uses_the_bf16_draw(mode):
    """One seed, one fp32 draw: the weight-only model's float weights are the
    bf16 model's, its int8 / int4 weights quantize that draw, the ViT and the
    projectors stay float, and it scores finite."""
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    bf16 = build_serving_model(tcfg, device="cpu", seed=3).state_dict()
    model = build_serving_model(tcfg, device="cpu", seed=3, **{mode: True})
    prec = model.precision
    assert getattr(prec, f"{mode}_weights") and prec.compute_dtype == torch.bfloat16
    q = model.state_dict()
    n_quantized = 0
    for k, v in bf16.items():
        if q[k].dtype == torch.int8:
            assert k.startswith("language_model.") and q[k + "_scale"].dtype == torch.float32
            n_quantized += 1
        else:
            assert torch.equal(q[k], v), k
    assert n_quantized == 2 * 5 + 1
    fp32 = build_serving_model(tcfg, device="cpu", seed=3,
                               precision=TorchPrecision.fp32()).state_dict()
    name = "language_model.layers.0.feed_forward.w2.weight"
    quantize = two.quantize_weight if mode == "int8" else two.quantize_kernel_int4
    assert torch.equal(q[name], quantize(fp32[name])[0])  # from fp32, not from a bf16 copy
    ids, mask = _prompt(AssessorConfig.tiny(stage=2), 1, 9)
    u8 = np.random.default_rng(10).integers(0, 256, (1, T, 56, 56, 3), dtype=np.uint8)
    scores = score_batch(model, _t(ids[:, None]).long(), _t(u8), _t(mask[:, None]))
    assert tuple(scores.shape) == (1, 1) and torch.isfinite(scores).all()
