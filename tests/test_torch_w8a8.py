"""The port's W8A8 serving path against the JAX package.

Inputs are made with numpy and go through both packages on the CPU:

- the int8 ops (`ops/w8a8.py`) against `aigv_assessor_tpu/ops/w8a8.py` and
  `tools/convert_to_int8.quantize_kernel`: int8 and int32 values exactly,
  fp32 outputs to 1e-5;
- the quantize kernels' plain versions (`ops/quant_fuse.py`, the versions
  the wrappers run on CPU tensors) against the JAX XLA fallbacks and against
  the Pallas kernels themselves in interpret mode, int8 values exactly;
- the W8A8 slice on `AssessorConfig.tiny(stage=2)` in fp32: one JAX tree,
  quantized by JAX's `quantize_for_serving(w8a8=True)`, mapped into the port
  by `state_dict_from_jax`. Both sides quantize the same fp32 activations
  with the same rounding, so the LLM and the teacher-forced forward hold the
  fp32 slice's 2e-4 (measured 3e-7). Where the ViT runs, an int8 value can
  round the other way: see VIT_REL_L2.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.cli.score import build_serving_model, score_batch
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import quantize_for_serving, state_dict_from_jax
from aigv_assessor_torch.models.lora import W8A8Linear
from aigv_assessor_torch.ops import quant_fuse as tqf
from aigv_assessor_torch.ops import w8a8 as tw8
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.ops import quant_fuse as jqf
from aigv_assessor_tpu.ops import w8a8 as jw8
from aigv_assessor_tpu.ops.preprocess import resize_normalize
from aigv_assessor_tpu.tools.convert_to_int8 import quantize_kernel as np_quantize_kernel

TOL = 2e-4  # the slice, as tests/test_torch_models.py holds the fp32 slice
OP_TOL = 1e-5  # fp32 outputs of one op
# In the ViT test, one of layer 0's 6144 GELU-feed int8 values lands on the
# other neighbour (XLA's and PyTorch's tanh differ by an ulp), and the
# change moves layer 1's row scales: 120 of its feed values differ by one.
# Measured: the ViT output 1.2e-3 relative L2 from JAX's (1.8e-3 on the
# score_batch frames), and score_batch's score 3.3e-4 from JAX's 1.32e-2,
# where the fp32 model scores 1.29e-2.
VIT_REL_L2 = 5e-3
SCORE_ATOL = 1e-3
CTX = 7
T = 4
TEXT = 16
W8A8_FP32 = TorchPrecision(compute_dtype=torch.float32, w8a8=True)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _j(x: np.ndarray, dtype=None):
    return jnp.asarray(x, dtype)


def _port_input(x: np.ndarray, dtype: str) -> torch.Tensor:
    t = _t(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax_input(x: np.ndarray, dtype: str):
    return _j(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _assert_quantized_equal(got, want, scale_rtol=0.0):
    q, s = got
    q2, s2 = (np.asarray(a) for a in want)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == q2.shape and tuple(s.shape) == s2.shape
    np.testing.assert_array_equal(q.numpy(), q2)
    np.testing.assert_allclose(s.numpy(), s2, rtol=scale_rtol, atol=0)


# ------------------------------------------------------------ int8 ops ---


@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 48)], ids=["2d", "3d"])
def test_quantize_rows_matches_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 3
    x[0, ..., :] = 0.0  # an all-zero row takes the 1e-8 floor
    _assert_quantized_equal(tw8.quantize_rows(_t(x)), jw8.quantize_rows(_j(x)))


def test_quantize_kernel_matches_numpy():
    """The weight scale is absmax / 127, or 1.0 for an all-zero channel."""
    w = np.random.default_rng(2).normal(size=(48, 24)).astype(np.float32) * 0.05  # [in, out]
    w[:, 3] = 0.0
    q_np, s_np = np_quantize_kernel(w)
    q, s = tw8.quantize_kernel(_t(w.T))  # the port stores [out, in]
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s[3] == 1.0
    np.testing.assert_array_equal(q.numpy(), q_np.T)
    np.testing.assert_array_equal(s.numpy(), s_np)


def _w8a8_operands(seed, m=6, k=32, n=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)  # JAX [in, out]
    sw = (rng.random(n) + 0.5).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    return x, wq, sw, bias


@pytest.mark.parametrize("prequantized", [False, True], ids=["float_in", "pair_in"])
def test_w8a8_matmul_matches_jax(prequantized):
    x, wq, sw, bias = _w8a8_operands(3)
    want = jw8.w8a8_matmul(
        jw8.quantize_rows(_j(x)) if prequantized else _j(x), _j(wq), _j(sw),
        bias=_j(bias), out_dtype=jnp.float32,
    )
    xin = tw8.quantize_rows(_t(x)) if prequantized else _t(x)
    got = tw8.w8a8_matmul(xin, _t(wq.T).contiguous(), _t(sw), _t(bias), torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL, atol=OP_TOL)


def test_int8_product_is_exact():
    """The int32 accumulator equals the exact integer product."""
    x, wq, _, _ = _w8a8_operands(4)
    xq, _ = tw8.quantize_rows(_t(x[0]))
    acc = tw8._int_mm(xq, _t(wq.T).contiguous())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), xq.numpy().astype(np.int64) @ wq.astype(np.int64))


def test_exact_when_activations_are_int():
    """tests/test_w8a8.py's lossless case: integer activations whose row
    absmax is 127 quantize with scale 1.0, so W8A8 equals the float product."""
    rng = np.random.default_rng(0)
    x = rng.integers(-126, 127, size=(5, 32)).astype(np.float32)
    x[:, 0] = 127.0
    wq = rng.integers(-127, 128, size=(32, 16)).astype(np.int8)
    sw = (rng.random(16) + 0.5).astype(np.float32)
    got = tw8.w8a8_matmul(_t(x), _t(wq.T).contiguous(), _t(sw), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), (x @ wq.astype(np.float32)) * sw, rtol=1e-5)


def test_w8a8_head_major_matches_jax_and_is_a_view():
    x, wq, sw, bias = _w8a8_operands(5, m=6, k=32, n=24)
    heads = 4
    want = jw8.w8a8_head_major(_j(x), _j(wq), _j(sw), heads, bias=_j(bias),
                               out_dtype=jnp.float32)
    layer = W8A8Linear(32, 24, out_dtype=torch.float32, heads=heads)
    layer.load_state_dict({"weight": _t(wq.T).contiguous(), "weight_scale": _t(sw),
                           "bias": _t(bias)})
    with torch.no_grad():
        got = layer(_t(x))
    assert tuple(got.shape) == want.shape == (2, heads, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL, atol=OP_TOL)
    # a strided view of the dense [B*S, N] product: heads step by D, rows by N
    assert not got.is_contiguous() and got.stride() == (6 * 24, 6, 24, 1)


def test_w8a8_rejects_a_float_pair_and_a_wrong_weight():
    x, wq, sw, _ = _w8a8_operands(6)
    with pytest.raises(TypeError, match="int8"):
        tw8.w8a8_matmul((_t(x), torch.ones(2, 6, 1)), _t(wq.T), _t(sw))
    with pytest.raises(ValueError, match="weight"):
        tw8.w8a8_matmul(_t(x), _t(wq.T).float(), _t(sw))


# ----------------------------------------------------- quantize kernels ---

ROWS, COLS, BLOCK = 40, 256, 16  # 40 rows: not a multiple of the 16-row blocks
# The feeds' scales may differ from JAX's by an ulp or two (at most 2.1e-7
# relative measured): XLA and PyTorch compute tanh, rsqrt and the row mean
# with other library code, and XLA under jit (the Pallas interpret run)
# rewrites the division by 127 as a product with 1/127. The int8 values
# are held as `_assert_feed_equal` says.
FEED_SCALE_RTOL = 1e-6


def _feed_inputs(dtype, seed=7):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(ROWS, COLS)) * 2.0).astype(np.float32)
    g = (rng.normal(size=COLS) * 0.2 + 1.0).astype(np.float32)
    b = (rng.normal(size=COLS) * 0.1).astype(np.float32)
    if dtype == "bfloat16":  # values both sides hold exactly in bf16
        x, g, b = (np.asarray(_j(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, g, b))
    return x, g, b


# Where JAX's own quotient y / s (y the feed's fp32 value before the
# quantizer) lies within TIE_BAND of a half-integer, an ulp of tanh or rsqrt
# decides the rounding, and those ulps differ between XLA's and PyTorch's
# code with the host's vector ISA: on one host 1 of the 10240 gelu_quant
# values came out one off JAX's. There the int8 values may differ by one;
# everywhere else they are equal. The number of such places is a property of
# the inputs, not of the host, and is held per (kernel, dtype).
TIE_BAND = 1e-4
NEAR_TIES = {("ln_quant", "float32"): 2, ("ln_quant", "bfloat16"): 0,
             ("gelu_quant", "float32"): 2, ("gelu_quant", "bfloat16"): 2}


def _jax_feed_values(kernel, dtype, eps=1e-6):
    """JAX's fp32 value before the quantizer (`_layernorm_quant_xla`'s and
    `_gelu_quant_xla`'s y) on the test's inputs."""
    x, g, b = (_jax_input(a, dtype).astype(jnp.float32) for a in _feed_inputs(dtype))
    if kernel == "gelu_quant":
        return np.asarray(jqf._gelu_tanh(x), np.float64)
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return np.asarray((x - mu) * jax.lax.rsqrt(var + eps) * g + b, np.float64)


def _assert_feed_equal(got, want, kernel, dtype):
    """`_assert_quantized_equal`, but where JAX's quotient is a near tie
    (NEAR_TIES of them) the int8 values may differ by one."""
    q, s = got
    q2, s2 = (np.asarray(a) for a in want)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == q2.shape and tuple(s.shape) == s2.shape
    np.testing.assert_allclose(s.numpy(), s2, rtol=FEED_SCALE_RTOL, atol=0)
    quot = _jax_feed_values(kernel, dtype) / s2.astype(np.float64)
    near = np.abs(np.abs(quot) % 1.0 - 0.5) < TIE_BAND
    assert int(near.sum()) == NEAR_TIES[kernel, dtype]
    diff = q.numpy().astype(np.int32) - q2.astype(np.int32)
    np.testing.assert_array_equal(diff[~near], 0)
    assert np.abs(diff[near]).max(initial=0) <= 1


def _assert_feed(got, want, kernel, dtype):
    if kernel == "ident_quant":  # no library function before the quantizer
        _assert_quantized_equal(got, want, FEED_SCALE_RTOL)
    else:
        _assert_feed_equal(got, want, kernel, dtype)


def _cases(dtype, eps=1e-6):
    """(port plain, JAX XLA fallback, JAX Pallas 2-D kernel) per kernel, on
    the same inputs in `dtype`."""
    x, g, b = _feed_inputs(dtype)
    t = lambda a: _port_input(a, dtype)  # noqa: E731
    j = lambda a: _jax_input(a, dtype)  # noqa: E731
    return {
        "ln_quant": (
            lambda: tqf.plain_layernorm_quant(t(x), t(g), t(b), eps),
            lambda: jqf._layernorm_quant_xla(j(x), j(g), j(b), eps),
            lambda: jqf._ln_quant_2d(j(x), j(g), j(b), _j([eps], jnp.float32), BLOCK),
        ),
        "gelu_quant": (
            lambda: tqf.plain_gelu_quant(t(x)),
            lambda: jqf._gelu_quant_xla(j(x)),
            lambda: jqf._gelu_quant_2d(j(x), BLOCK),
        ),
        "ident_quant": (
            lambda: tqf.plain_quant_rows(t(x)),
            lambda: jw8.quantize_rows(j(x)),
            lambda: jqf._ident_quant_2d(j(x), BLOCK),
        ),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ln_quant", "gelu_quant", "ident_quant"])
def test_plain_feed_matches_xla_fallback(kernel, dtype):
    plain, xla, _ = _cases(dtype)[kernel]
    _assert_feed(plain(), xla(), kernel, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ln_quant", "gelu_quant", "ident_quant"])
def test_plain_feed_matches_pallas_interpret(kernel, dtype):
    from jax.experimental.pallas import tpu as pltpu

    plain, _, pallas = _cases(dtype)[kernel]
    with pltpu.force_tpu_interpret_mode():
        want = pallas()
    _assert_feed(plain(), want, kernel, dtype)


def test_feed_wrappers_run_plain_on_cpu_without_counting():
    x, g, b = (_t(a) for a in _feed_inputs("float32"))
    counters = (tqf.layernorm_quant, tqf.gelu_quant, tqf.quant_rows)
    before = [f.launches for f in counters]
    for got, want in (
        (tqf.layernorm_quant(x, g, b, 1e-6), tqf.plain_layernorm_quant(x, g, b, 1e-6)),
        (tqf.gelu_quant(x), tqf.plain_gelu_quant(x)),
        (tqf.quant_rows(x), tqf.plain_quant_rows(x)),
    ):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tqf.quant_rows(torch.empty((4, 16), device="meta"))


def test_quantized_feed_into_w8a8_matmul():
    """A fused feed's (q, s) pair drops into `w8a8_matmul` and gives what
    quantizing the producer's float output inside the matmul gives."""
    x, g, b = (_t(a) for a in _feed_inputs("float32"))
    rng = np.random.default_rng(8)
    wq = _t(rng.integers(-127, 128, (64, COLS)).astype(np.int8))
    sw = _t((rng.random(64) + 0.5).astype(np.float32) * 2e-2)
    y = torch.nn.functional.layer_norm(x, (COLS,), g, b, 1e-6)
    torch.testing.assert_close(
        tw8.w8a8_matmul(tqf.layernorm_quant(x, g, b, 1e-6), wq, sw, out_dtype=torch.float32),
        tw8.w8a8_matmul(y, wq, sw, out_dtype=torch.float32),
        rtol=1e-5, atol=1e-5,
    )


# ---------------------------------------------------------------- slice ---


@pytest.fixture(scope="module")
def w8a8_pair():
    """(JAX W8A8 model, its params, port W8A8 model, JAX fp32 params, JAX
    config): one fp32 tree, quantized by the JAX package and mapped into the
    port."""
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    rng = np.random.default_rng(0)
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(rng.integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    host = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    qparams, prec = jax_quantize_for_serving(host, Precision.fp32(), w8a8=True)
    assert prec.w8a8
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    port = TorchAssessor(tcfg, W8A8_FP32)
    port.load_state_dict(state_dict_from_jax(qparams, tcfg, W8A8_FP32), strict=True)
    return AIGVAssessor(cfg, prec), qparams, port.eval(), host, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _rel_l2(got, want) -> float:
    got, want = np.float64(got.detach().numpy()), np.float64(np.asarray(want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


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


def test_w8a8_vit_matches(w8a8_pair):
    """K4a, the head-major int8 qkv, K1 `bsd` over the 17-of-24 padded
    tokens, K4c into proj, and fc1 -> K4b -> fc2."""
    model, params, port, _, _ = w8a8_pair
    frames = np.random.default_rng(1).normal(size=(T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(frames), method=lambda m, x: m.vision_model(x))
    with torch.no_grad():
        got = port.vision_model(_t(frames))
    assert tuple(got.shape) == want.shape
    assert _rel_l2(got, want) <= VIT_REL_L2


def test_w8a8_internlm2_hidden_matches(w8a8_pair):
    model, params, port, _, cfg = w8a8_pair
    embeds = np.random.default_rng(2).normal(size=(2, 21, cfg.llm.hidden_size))
    embeds = embeds.astype(np.float32)
    want = model.apply(
        params, jnp.asarray(embeds),
        method=lambda m, e: m.language_model(inputs_embeds=e, with_logits=False)[1],
    )
    with torch.no_grad():
        got = port.language_model(inputs_embeds=_t(embeds), with_logits=False)[1]
    _close(got, want)


def test_w8a8_forward_and_scores_match(w8a8_pair):
    """The slice as a whole: the teacher-forced forward's hidden state and
    score, and uint8 frames through `score_batch`."""
    model, params, port, _, cfg = w8a8_pair
    ids, mask = _prompt(cfg, 2, 4)
    px = np.random.default_rng(5).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"])

    u8 = np.random.default_rng(8).integers(0, 256, (2, T, 56, 56, 3), dtype=np.uint8)
    pv = resize_normalize(jnp.asarray(u8), size=56, dtype=jnp.float32)
    want = model.apply(params, jnp.asarray(ids[:, None]), pv, jnp.asarray(mask[:, None]),
                       method="score_perspectives")
    got = score_batch(port, _t(ids[:, None]).long(), _t(u8), _t(mask[:, None]))
    assert tuple(got.shape) == (2, 1) and got.dtype == torch.float32
    _close(got, want, SCORE_ATOL)


def test_port_quantize_for_serving_equals_jax_tree(w8a8_pair):
    """The port's quantization of the same fp32 weights gives the mapped JAX
    W8A8 tree exactly, dtypes included."""
    _, qparams, _, host, _ = w8a8_pair
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    got = quantize_for_serving(state_dict_from_jax(host, tcfg), tcfg)
    want = state_dict_from_jax(qparams, tcfg, W8A8_FP32)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    n_int8 = sum(v.dtype == torch.int8 for v in want.values())
    assert n_int8 == 2 * 4 + 2 * 5  # ViT qkv/proj/fc1/fc2, LLM wqkv/wo/w1/w2/w3, 2 layers each
    with pytest.raises(TypeError, match="fp32"):
        quantize_for_serving({k: v.to(torch.bfloat16) for k, v in
                              state_dict_from_jax(host, tcfg).items()}, tcfg)


def test_bf16_cast_keeps_scales_fp32(w8a8_pair):
    """`.to(torch.bfloat16)` casts the float weights and biases, keeps the
    int8 weights and the fp32 scales, as `cast_params_for_inference` does."""
    _, _, port, _, _ = w8a8_pair
    tcfg = TorchConfig.tiny(stage=2)
    model = TorchAssessor(tcfg, TorchPrecision(w8a8=True))
    model.load_state_dict(port.state_dict())
    model = model.to(torch.bfloat16)
    lin = [m for m in model.modules() if isinstance(m, W8A8Linear)]
    assert len(lin) == 18
    for m in lin:
        assert m.weight.dtype == torch.int8 and m.weight_scale.dtype == torch.float32
        assert m.bias is None or m.bias.dtype == torch.bfloat16
    ref = dict(port.state_dict())
    for k, v in model.state_dict().items():
        if k.endswith("weight_scale"):
            assert torch.equal(v, ref[k]), k
    assert model.language_model.output.weight.dtype == torch.bfloat16


def test_build_serving_model_w8a8_uses_the_bf16_draw():
    """One seed, one fp32 draw: the W8A8 model's float weights are the bf16
    model's, its int8 weights quantize that draw, and it scores finite."""
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    bf16 = build_serving_model(tcfg, device="cpu", seed=3).state_dict()
    model = build_serving_model(tcfg, device="cpu", seed=3, w8a8=True)
    assert model.precision.w8a8 and model.precision.compute_dtype == torch.bfloat16
    q = model.state_dict()
    for k, v in bf16.items():
        if q[k].dtype == torch.int8:
            assert q[k.replace(".weight", ".weight_scale")].dtype == torch.float32
        else:
            assert torch.equal(q[k], v), k
    ids, mask = _prompt(AssessorConfig.tiny(stage=2), 1, 9)
    u8 = np.random.default_rng(10).integers(0, 256, (1, T, 56, 56, 3), dtype=np.uint8)
    scores = score_batch(model, _t(ids[:, None]).long(), _t(u8), _t(mask[:, None]))
    assert tuple(scores.shape) == (1, 1) and torch.isfinite(scores).all()
