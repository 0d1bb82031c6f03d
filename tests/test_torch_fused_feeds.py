"""W8A8 with fused decoder feeds: the port against the JAX package on the CPU.

Inputs are made with numpy and go through both packages:

- the plain versions of the RMSNorm and SwiGLU quantize kernels (K5a
  `rmsnorm_quant`, K5b `silu_mul_quant`, the versions the wrappers run on CPU
  tensors) against JAX's XLA fallbacks and against the Pallas kernels in
  interpret mode, in fp32 and bf16: int8 values exactly, scales to 1e-6;
- the W8A8 slice on `AssessorConfig.tiny(stage=2)` in fp32 with both
  `Precision.fuse_quant` and `Precision.quant_rows` at {"vit", "llm"},
  against JAX under `AIGV_FUSE_QUANT=vit,llm AIGV_QUANT_ROWS=vit,llm` (JAX
  reads them while it traces, so they are set around each JAX call): the
  forward's hidden state and score, shared-prefix perspective scores (the
  decoder's row-major branch with the int8 pair) and a prefill with decode
  steps, at `tests/test_torch_w8a8.py`'s tolerances; and the ViT with both
  fields empty against JAX with both switches '0'.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import KVCache as TorchKVCache
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_torch.ops import quant_fuse as tqf
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.internlm2 import KVCache
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.ops import quant_fuse as jqf

TOL = 2e-4  # tests/test_torch_w8a8.py: the slice
SCORE_ATOL = 1e-3
VIT_REL_L2 = 5e-3  # tests/test_torch_w8a8.py: XLA's and PyTorch's tanh differ by an ulp
# prefill + decode logits: tests/test_torch_decode.py's W8A8 bound (a last-bit
# difference can flip an int8 value, a quantization step's worth downstream)
DECODE_TOL = 2e-3
FEED_SCALE_RTOL = 1e-6  # tests/test_torch_w8a8.py: an ulp or two of the scale
ROWS, COLS, BLOCK = 40, 256, 16
CTX = 7
T = 4
TEXT = 16
BOTH = frozenset({"vit", "llm"})


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


@contextlib.contextmanager
def jax_gates(value: str):
    """JAX's fused-feed switches, which its gates read from `os.environ`
    while tracing. The mapping is swapped at the Python level: setting the
    process environment (setenv) races with the XLA threads' getenv."""
    env = {**os.environ, "AIGV_FUSE_QUANT": value, "AIGV_QUANT_ROWS": value}
    with mock.patch.object(os, "environ", env):
        yield


def _assert_quantized_equal(got, want):
    q, s = got
    q2, s2 = (np.asarray(a) for a in want)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == q2.shape and tuple(s.shape) == s2.shape
    np.testing.assert_array_equal(q.numpy(), q2)
    np.testing.assert_allclose(s.numpy(), s2, rtol=FEED_SCALE_RTOL, atol=0)


# ------------------------------------------------------- K5a / K5b plain ---


def _feed_inputs(dtype, seed=7):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(ROWS, COLS)) * 2.0).astype(np.float32)
    x3 = (rng.normal(size=(ROWS, COLS)) * 2.0).astype(np.float32)
    g = (rng.normal(size=COLS) * 0.2 + 1.0).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    if dtype == "bfloat16":  # values both sides hold exactly in bf16
        x, x3, g = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                    for a in (x, x3, g))
    return x, x3, g


def _cases(dtype, eps=1e-5):
    """(port plain, JAX XLA fallback, JAX Pallas 2-D kernel) per kernel."""
    x, x3, g = _feed_inputs(dtype)
    bf16 = dtype == "bfloat16"
    t = lambda a: _t(a).to(torch.bfloat16) if bf16 else _t(a)  # noqa: E731
    j = lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)  # noqa: E731
    return {
        "rms_quant": (
            lambda: tqf.plain_rmsnorm_quant(t(x), t(g), eps),
            lambda: jqf._rmsnorm_quant_xla(j(x), j(g), eps),
            lambda: jqf._rms_quant_2d(j(x), j(g), jnp.asarray([eps], jnp.float32), BLOCK),
        ),
        "silu_mul_quant": (
            lambda: tqf.plain_silu_mul_quant(t(x), t(x3)),
            lambda: jqf._silu_mul_quant_xla(j(x), j(x3)),
            lambda: jqf._silu_mul_quant_2d(j(x), j(x3), BLOCK),
        ),
    }


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["rms_quant", "silu_mul_quant"])
def test_plain_decoder_feed_matches_jax(kernel, dtype, reference):
    from jax.experimental.pallas import tpu as pltpu

    plain, xla, pallas = _cases(dtype)[kernel]
    if reference == "xla":
        want = xla()
    else:
        with pltpu.force_tpu_interpret_mode():
            want = pallas()
    _assert_quantized_equal(plain(), want)


def test_decoder_feed_wrappers_run_plain_on_cpu_without_counting():
    x, x3, g = (_t(a) for a in _feed_inputs("float32"))
    counters = (tqf.rmsnorm_quant, tqf.silu_mul_quant)
    before = [f.launches for f in counters]
    for got, want in (
        (tqf.rmsnorm_quant(x, g, 1e-5), tqf.plain_rmsnorm_quant(x, g, 1e-5)),
        (tqf.silu_mul_quant(x, x3), tqf.plain_silu_mul_quant(x, x3)),
    ):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tqf.silu_mul_quant(torch.empty((4, 16), device="meta"), torch.empty((4, 16)))
    # the 8B decoder's SwiGLU feed is 14336 wide: within the kernel's reach
    assert tqf.MAX_COLS >= 16384


def test_precision_components():
    p = TorchPrecision(w8a8=True, fuse_quant={"llm", "vit"}, quant_rows=())
    assert p.fuse_quant == BOTH and p.quant_rows == frozenset()
    assert TorchPrecision().fuse_quant == TorchPrecision().quant_rows == frozenset({"vit"})
    hash(p)
    with pytest.raises(ValueError, match="components"):
        TorchPrecision(fuse_quant={"decoder"})


# ---------------------------------------------------------------- slice ---


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX W8A8 model, its params, port W8A8 model with both fields at
    {"vit", "llm"}, JAX config, port config): one fp32 tree, quantized by the
    JAX package and mapped into the port."""
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(np.random.default_rng(0).integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    host = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    qparams, prec = jax_quantize_for_serving(host, Precision.fp32(), w8a8=True)
    qparams = jax.device_get(qparams)
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    tprec = TorchPrecision(compute_dtype=torch.float32, w8a8=True, fuse_quant=BOTH,
                           quant_rows=BOTH)
    port = TorchAssessor(tcfg, tprec)
    port.load_state_dict(state_dict_from_jax(qparams, tcfg, tprec), strict=True)
    return AIGVAssessor(cfg, prec), qparams, port.eval(), cfg, tcfg


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
    mask[:, n - 3 :] = False
    ids[:, n - 3 :] = 2
    return ids, mask


def test_fused_forward_goes_through_every_feed(fused_pair):
    """Per forward of the tiny model (2 + 2 layers): K4a 4, K4b 2, K4c 2 + 2,
    K5a 4, K5b 2 calls of the wrappers; with both fields empty, none."""
    _, _, port, cfg, tcfg = fused_pair
    ids, mask = _prompt(cfg, 1, 3)
    px = np.random.default_rng(4).normal(size=(1, T, 56, 56, 3)).astype(np.float32)
    names = ("layernorm_quant", "gelu_quant", "quant_rows", "rmsnorm_quant", "silu_mul_quant")

    def calls(model):
        counts = dict.fromkeys(names, 0)

        def counting(name):
            fn = getattr(tqf, name)

            def wrapper(*args, **kwargs):
                counts[name] += 1
                return fn(*args, **kwargs)
            return wrapper

        with contextlib.ExitStack() as stack:
            for name in names:
                stack.enter_context(mock.patch.object(tqf, name, counting(name)))
            with torch.no_grad():
                model(_t(ids).long(), _t(px), _t(mask))
        return counts

    assert calls(port) == dict(layernorm_quant=4, gelu_quant=2, quant_rows=4, rmsnorm_quant=4,
                               silu_mul_quant=2)
    unfused = TorchAssessor(tcfg, TorchPrecision(compute_dtype=torch.float32, w8a8=True,
                                                 fuse_quant=(), quant_rows=()))
    unfused.load_state_dict(port.state_dict())
    assert calls(unfused.eval()) == dict.fromkeys(names, 0)


def test_fused_forward_and_scores_match(fused_pair):
    """The teacher-forced forward's hidden state and score."""
    model, params, port, cfg, _ = fused_pair
    ids, mask = _prompt(cfg, 2, 4)
    px = np.random.default_rng(5).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    with jax_gates("vit,llm"):
        want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                           with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"])


def _perspective_prompts(cfg, b, p, seed, suffix=9):
    """[B, P, N] ids sharing one token, every context slot and two more
    tokens; perspective j right-padded by j; and the shared length."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    prefix = 1 + n_ctx + 2
    ids = rng.integers(10, cfg.llm.vocab_size, (b, p, prefix + suffix)).astype(np.int32)
    ids[ids == CTX] = 10
    ids[:, :, :prefix] = ids[:, :1, :prefix]
    ids[:, :, 1 : 1 + n_ctx] = CTX
    ids[:, :, prefix] = 10 + np.arange(p)
    mask = np.ones(ids.shape, bool)
    for j in range(1, p):
        mask[:, j, -j:] = False
        ids[:, j, -j:] = cfg.llm.pad_token_id
    return ids, mask, prefix


def test_fused_shared_prefix_scores_match(fused_pair):
    """Shared-prefix scoring: the suffix pass is the row-major branch with a
    cache, fed the int8 pair."""
    model, params, port, cfg, _ = fused_pair
    ids, mask, prefix = _perspective_prompts(cfg, 2, 3, seed=13)
    px = np.random.default_rng(14).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    with jax_gates("vit,llm"):
        want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                           method="score_perspectives", shared_prefix_len=prefix)
    with torch.no_grad():
        got = port.score_perspectives(_t(ids).long(), _t(px), _t(mask),
                                      shared_prefix_len=prefix)
    assert tuple(got.shape) == (2, 3) and got.abs().max() > 0
    _close(got, want, SCORE_ATOL)


def test_fused_prefill_and_decode_steps_match(fused_pair):
    model, params, port, cfg, _ = fused_pair
    b, prompt, steps, cap = 2, 9, 2, 16
    ids = np.random.default_rng(6).integers(5, cfg.llm.vocab_size, (b, prompt + steps))
    want = []
    with jax_gates("vit,llm"):
        cache = KVCache.init(cfg.llm, b, cap, dtype=jnp.float32)
        embeds = model.apply(params, jnp.asarray(ids[:, :prompt]), method="embed_tokens")
        logits, _, cache = model.apply(params, embeds, cache, method="prefill")
        want.append(logits)
        for i in range(prompt, prompt + steps):
            logits, _, cache = model.apply(params, jnp.asarray(ids[:, i : i + 1]), cache,
                                           method="decode_step")
            want.append(logits)
    got = []
    tcache = TorchKVCache.init(port.config.llm, b, cap, dtype=torch.float32)
    with torch.no_grad():
        logits, _, tcache = port.prefill(port.embed_tokens(_t(ids[:, :prompt]).long()), tcache)
        got.append(logits)
        for i in range(prompt, prompt + steps):
            logits, _, tcache = port.decode_step(_t(ids[:, i : i + 1]).long(), tcache)
            got.append(logits)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"logits, step {step}")


def test_vit_without_fused_feeds_matches_jax_gates_off(fused_pair):
    """Both fields empty: norm1/norm2, the GELU and the attention output go
    to their projections unfused, as JAX does with both switches '0'."""
    model, params, port, _, tcfg = fused_pair
    unfused = TorchAssessor(tcfg, TorchPrecision(compute_dtype=torch.float32, w8a8=True,
                                                 fuse_quant=(), quant_rows=()))
    unfused.load_state_dict(port.state_dict())
    frames = np.random.default_rng(1).normal(size=(T, 56, 56, 3)).astype(np.float32)
    with jax_gates("0"):
        want = model.apply(params, jnp.asarray(frames), method=lambda m, x: m.vision_model(x))
    with torch.no_grad():
        got = unfused.eval().vision_model(_t(frames))
    assert tuple(got.shape) == want.shape
    assert _rel_l2(got, want) <= VIT_REL_L2
