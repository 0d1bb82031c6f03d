"""The port's KV cache path against the JAX package, on the CPU.

Inputs come from numpy seeds and go through the JAX function and its
counterpart in the port; everything is fp32 unless stated. The port's
decode-attention wrapper runs its plain version on CPU tensors; the JAX
Pallas kernel runs in interpret mode, as `tests/test_decode_attention.py`
runs it.

- `quantize_kv_rows` / `dequantize_kv_rows`: equal to JAX's, zero rows too.
- `two_part_cached_attention` in all its modes at 1e-5.
- `plain_decode_attention` (+ `merge_new_token`) against the Pallas kernel
  (out, m, l each) and against JAX's `two_part_cached_attention` with one
  token, at 1e-5 (2e-5 for the merged output, the JAX tests' own bound).
- tiny InternLM2 through `AIGVAssessor.prefill` / `decode_step` on the JAX
  weights: logits, hidden and cache contents at 2e-4; under `kv_int8` the
  int8 rows equal except where a value straddles a rounding boundary (at most
  1e-3 of them, by one) and logits at 2e-3, a quantization step's worth;
  under int8 / int4 weights at 2e-4; and decode equal to the cache-free
  forward at the same positions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import LLMConfig as TorchLLMConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import KVCache as TorchKVCache
from aigv_assessor_torch.models.loading import serving_precision, state_dict_from_jax
from aigv_assessor_torch.ops import attention as t_attn
from aigv_assessor_torch.ops import decode_attention as t_dec
from aigv_assessor_torch.ops import kv_quant as t_kvq
from aigv_assessor_tpu.core.config import AssessorConfig, LLMConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.internlm2 import KVCache
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.ops import kv_quant as j_kvq
from aigv_assessor_tpu.ops.attention import two_part_cached_attention as j_two_part
from aigv_assessor_tpu.ops.decode_attention import decode_attention as j_decode_attention
from aigv_assessor_tpu.ops.decode_attention import merge_new_token as j_merge

ATOL = 1e-5  # attention functions, fp32 on both sides
MODEL_TOL = 2e-4  # whole models, as the JAX package's differential tests
CTX = 7


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------- kv quantizer --


@pytest.mark.parametrize("shape", [(2, 5, 2, 16), (3, 2, 7, 4, 64)])
def test_kv_quantizer_equals_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    x[0, 1] = 0.0  # zero rows: scale 1, zeros
    x[1, 0, ..., 0] = 12.7  # a large value that sets the scale exactly
    q, s = t_kvq.quantize_kv_rows(_t(x))
    jq, js = j_kvq.quantize_kv_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[0, 1] == 1.0).all() and not q[0, 1].any()
    deq = t_kvq.dequantize_kv_rows(q, s)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(j_kvq.dequantize_kv_rows(jq, js)))
    assert not deq[0, 1].any()


def test_make_cache_rows_follows_the_cache():
    rng = np.random.default_rng(1)
    k, v = (_t(rng.normal(size=(2, 3, 2, 16)).astype(np.float32)) for _ in range(2))
    cache = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16)
    kn, vn = t_kvq.make_cache_rows(k, v, cache, cache)
    assert kn.dtype == vn.dtype == torch.bfloat16
    qcache = (torch.zeros((2, 8, 2, 16), dtype=torch.int8), torch.ones((2, 8, 2)))
    (kq, ks), (vq, vs) = t_kvq.make_cache_rows(k, v, qcache, qcache)
    want = t_kvq.quantize_kv_rows(k)
    assert torch.equal(kq, want[0]) and torch.equal(ks, want[1])
    assert vq.dtype == torch.int8 and vs.shape == (2, 3, 2)
    assert t_kvq.is_quantized(qcache) and not t_kvq.is_quantized(cache)


# ----------------------------------------------- two_part_cached_attention --


def _two_part_inputs(b, s, hq, hkv, d, max_len, seed):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
              (b, max_len, hkv, d), (b, max_len, hkv, d)]
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


TWO_PART = {
    # name: (b, s, hq, hkv, d, max_len, cache_index, left pads per sample, block_causal, int8)
    "plain_gqa": (2, 5, 4, 2, 16, 24, 9, None, None, False),
    "mha": (2, 4, 4, 4, 16, 20, 7, None, None, False),
    "index0_prefill": (2, 6, 4, 2, 16, 12, 0, None, None, False),
    "left_padded_prefill": (3, 6, 4, 2, 16, 12, 0, (0, 2, 4), None, False),
    "left_padded_decode": (3, 1, 8, 2, 64, 16, 9, (0, 3, 8), None, False),
    "block_causal_2_groups": (2, 8, 4, 2, 16, 30, 11, None, 4, False),
    "block_causal_3_groups": (2, 9, 4, 2, 16, 30, 11, None, 3, False),
    "int8_cache": (2, 3, 4, 2, 16, 24, 10, None, None, True),
    "int8_cache_left_padded": (2, 1, 4, 2, 16, 24, 10, (0, 4), None, True),
}


@pytest.mark.parametrize("name", list(TWO_PART))
def test_two_part_cached_attention_matches_jax(name):
    b, s, hq, hkv, d, max_len, idx, pads, block_causal, int8 = TWO_PART[name]
    q, k, v, ck, cv = _two_part_inputs(b, s, hq, hkv, d, max_len, seed=len(name))
    kv_mask = None
    if pads is not None:
        kv_mask = np.ones((b, max_len), bool)
        for i, p in enumerate(pads):
            kv_mask[i, :p] = False
    if int8:
        jck, jcv = j_kvq.quantize_kv_rows(jnp.asarray(ck)), j_kvq.quantize_kv_rows(jnp.asarray(cv))
        tck = tuple(_t(a) for a in jck)
        tcv = tuple(_t(a) for a in jcv)
    else:
        jck, jcv, tck, tcv = jnp.asarray(ck), jnp.asarray(cv), _t(ck), _t(cv)
    want = j_two_part(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jck, jcv, jnp.asarray(idx, jnp.int32),
        None if kv_mask is None else jnp.asarray(kv_mask), block_causal=block_causal)
    got = t_attn.two_part_cached_attention(
        _t(q), _t(k), _t(v), tck, tcv, idx, None if kv_mask is None else _t(kv_mask),
        block_causal=block_causal)
    assert tuple(got.shape) == (b, s, hq, d) and got.dtype == torch.float32
    _close(got, want)


def test_two_part_rounds_probabilities_to_a_bf16_cache():
    """The JAX generate() keeps a bf16 cache under an fp32 model: p is rounded
    to bf16 before the cache's PV product on both sides. bf16 rounding of p
    can differ where the fp32 p differs in its last bits: 2e-3."""
    q, k, v, ck, cv = _two_part_inputs(2, 2, 4, 2, 16, 16, seed=3)
    jck, jcv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (ck, cv))
    want = j_two_part(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jck, jcv,
                      jnp.asarray(9, jnp.int32), None)
    got = t_attn.two_part_cached_attention(
        _t(q), _t(k), _t(v), _t(ck).to(torch.bfloat16), _t(cv).to(torch.bfloat16), 9, None)
    _close(got, want, 2e-3)


# ------------------------------------------------------ decode attention (K8) --

DECODE = {
    # name: (b, hq, hkv, d, max_len, end, starts)
    "full_window_d128": (2, 8, 4, 128, 64, 37, (0, 0)),
    "ragged_starts_d128": (3, 16, 8, 128, 64, 48, (0, 17, 40)),
    "gqa_8_over_2_d64": (2, 8, 2, 64, 56, 55, (0, 9)),
    "mha_d64_end_off_block": (2, 8, 8, 64, 56, 17, (3, 16)),
    "empty_cache": (2, 8, 4, 64, 32, 0, (0, 0)),
    "one_row_window": (2, 16, 8, 128, 32, 20, (19, 0)),
}


def _decode_inputs(name):
    b, hq, hkv, d, max_len, end, starts = DECODE[name]
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, 1, hkv, d)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.normal(size=(b, max_len, hkv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, ck, cv, np.asarray(starts, np.int32), end


@pytest.mark.parametrize("name", list(DECODE))
def test_plain_decode_attention_matches_pallas_kernel(name):
    """(out, m, l) of the plain version against the Pallas kernel in interpret
    mode, with a block of 16 rows so windows start and end inside blocks."""
    q, _, _, ck, cv, starts, end = _decode_inputs(name)
    want = j_decode_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(starts),
        jnp.asarray(end, jnp.int32), blk=16, interpret=True)
    got = t_dec.plain_decode_attention(_t(q[:, 0]), _t(ck), _t(cv), _t(starts), end)
    for g, w, what in zip(got, want, ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ATOL, atol=ATOL, err_msg=what)
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = t_dec.decode_attention.launches
    again = t_dec.decode_attention(_t(q[:, 0]), _t(ck), _t(cv), _t(starts), torch.tensor(end))
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert t_dec.decode_attention.launches == before
    if end == 0:
        assert not got[0].any() and not got[2].any() and (got[1] == -1e30).all()


@pytest.mark.parametrize("name", list(DECODE))
def test_cached_decode_attention_matches_jax_two_part(name):
    """Kernel window + merged current token against JAX's one-token
    `two_part_cached_attention` with the left-padding mask that gives these
    starts, and the merge against JAX's `merge_new_token`."""
    q, k, v, ck, cv, starts, end = _decode_inputs(name)
    b, max_len = ck.shape[:2]
    kv_mask = np.ones((b, max_len), bool)
    for i, st in enumerate(starts):
        kv_mask[i, :st] = False
    want = j_two_part(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ck),
                      jnp.asarray(cv), jnp.asarray(end, jnp.int32), jnp.asarray(kv_mask))
    got = t_dec.cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), end, _t(kv_mask))
    assert tuple(got.shape) == q.shape
    _close(got, want, 2e-5)
    old = t_dec.plain_decode_attention(_t(q[:, 0]), _t(ck), _t(cv), _t(starts), end)
    jmerged = j_merge(*(jnp.asarray(o.numpy()) for o in old), jnp.asarray(q[:, 0]),
                      jnp.asarray(k), jnp.asarray(v))
    _close(t_dec.merge_new_token(*old, _t(q[:, 0]), _t(k), _t(v)), jmerged)
    # without a mask the windows start at row 0
    if not starts.any():
        nomask = t_dec.cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), end, None)
        assert torch.equal(nomask, got)


def test_decode_kernel_supported_is_the_shape_test():
    assert t_dec.decode_kernel_supported(16, 8, 128)
    assert t_dec.decode_kernel_supported(8, 8, 64)
    assert not t_dec.decode_kernel_supported(4, 2, 128)  # fewer than 8 query heads
    assert not t_dec.decode_kernel_supported(16, 8, 16)  # head dim
    assert not t_dec.decode_kernel_supported(12, 8, 64)  # not grouped


# ---------------------------------------------------- prefill + decode steps --

LLMS = {
    # D = 16: every step runs two_part_cached_attention
    "tiny": {},
    # 8 query heads of D = 64: a decode step reaches cached_decode_attention
    "d64": dict(hidden_size=512, num_attention_heads=8, num_key_value_heads=2),
}


@pytest.fixture(scope="module", params=list(LLMS))
def pair(request):
    """(JAX model, fp32 JAX params, JAX config, port config) on one tiny
    decoder shape."""
    kw = LLMS[request.param]
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    cfg = cfg.replace(llm=dataclasses.replace(LLMConfig.tiny(), **kw))
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    tcfg = tcfg.replace(llm=dataclasses.replace(TorchLLMConfig.tiny(), **kw))
    model = AIGVAssessor(cfg, Precision.fp32())
    ids = jnp.zeros((1, 4 * cfg.num_image_token + 9), jnp.int32)
    px = jnp.zeros((1, 4, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    return request.param, model, params, cfg, tcfg


B, PROMPT, STEPS, CAP = 2, 9, 3, 16


def _run_jax(model, params, ids, cache_dtype, quantized):
    cache = KVCache.init(model.config.llm, B, CAP, dtype=cache_dtype, quantized=quantized)
    out = []
    logits, hidden, cache = model.apply(
        params, model.apply(params, jnp.asarray(ids[:, :PROMPT]), method="embed_tokens"), cache,
        method="prefill")
    out.append((logits, hidden))
    for i in range(PROMPT, PROMPT + STEPS):
        logits, hidden, cache = model.apply(
            params, jnp.asarray(ids[:, i : i + 1]), cache, method="decode_step")
        out.append((logits, hidden))
    return out, cache


def _run_port(port, ids, cache_dtype, quantized):
    cache = TorchKVCache.init(port.config.llm, B, CAP, dtype=cache_dtype, quantized=quantized)
    out = []
    with torch.no_grad():
        logits, hidden, cache = port.prefill(port.embed_tokens(_t(ids[:, :PROMPT]).long()), cache)
        out.append((logits, hidden))
        for i in range(PROMPT, PROMPT + STEPS):
            logits, hidden, cache = port.decode_step(_t(ids[:, i : i + 1]).long(), cache)
            out.append((logits, hidden))
    return out, cache


@pytest.mark.parametrize("mode", ["fp32", "kv_int8", "int8", "int4", "w8a8"])
def test_prefill_and_decode_steps_match_jax(pair, mode):
    name, model, params, cfg, tcfg = pair
    flags = {} if mode in ("fp32", "kv_int8") else {mode: True}
    kv_int8 = mode == "kv_int8"
    qparams, prec = jax_quantize_for_serving(params, Precision.fp32(), kv_int8=kv_int8, **flags)
    qmodel = AIGVAssessor(cfg, prec)
    tprec = serving_precision(TorchPrecision.fp32(), kv_int8=kv_int8, **flags)
    assert tprec.kv_int8 == prec.kv_int8 == kv_int8
    port = TorchAssessor(tcfg, tprec)
    port.load_state_dict(state_dict_from_jax(jax.device_get(qparams), tcfg, tprec), strict=True)
    port.eval()
    ids = np.random.default_rng(5).integers(5, cfg.llm.vocab_size, (B, PROMPT + STEPS))

    launches = t_dec.decode_attention.launches
    want, jcache = _run_jax(qmodel, qparams, ids, jnp.float32, kv_int8)
    got, tcache = _run_port(port, ids, torch.float32, kv_int8)
    assert t_dec.decode_attention.launches == launches  # CPU tensors: the plain version
    assert tcache.index == PROMPT + STEPS == int(tcache.index_dev) == int(jcache.index)
    # W8A8 re-quantizes activations per row: a last-bit difference can flip
    # an int8 value, a quantization step's worth downstream
    tol = {"kv_int8": 2e-3, "w8a8": 2e-3}.get(mode, MODEL_TOL)
    for step, ((gl, gh), (wl, wh)) in enumerate(zip(got, want)):
        assert gl.dtype == torch.float32 and gl.shape[-1] == cfg.llm.vocab_size
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=tol, atol=tol,
                                   err_msg=f"logits, step {step}")
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=tol, atol=tol,
                                   err_msg=f"hidden, step {step}")
    n = PROMPT + STEPS
    if kv_int8:
        for part, jpart in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            tq, ts = part[0][:, :, :n].int().numpy(), part[1][:, :, :n].numpy()
            jq, js = np.asarray(jpart[0][:, :, :n]).astype(np.int32), np.asarray(jpart[1][:, :, :n])
            diff = np.abs(tq - jq)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
            np.testing.assert_allclose(ts, js, rtol=1e-4, atol=0)
            assert not part[0][:, :, n:].any() and (part[1][:, :, n:] == 1).all()
    else:
        np.testing.assert_allclose(tcache.k[:, :, :n].numpy(), np.asarray(jcache.k[:, :, :n]),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(tcache.v[:, :, :n].numpy(), np.asarray(jcache.v[:, :, :n]),
                                   rtol=tol, atol=tol)
        assert not tcache.k[:, :, n:].any() and not tcache.v[:, :, n:].any()


def test_decode_equals_cache_free_forward(pair):
    """Teacher forcing: prefill + decode steps give the logits of one
    cache-free forward over the same tokens (another attention path, the same
    function), and `capture_kv` gives the rows the cache holds."""
    _, _, params, cfg, tcfg = pair
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    port.eval()
    ids = np.random.default_rng(6).integers(5, cfg.llm.vocab_size, (B, PROMPT + STEPS))
    got, cache = _run_port(port, ids, torch.float32, False)
    with torch.no_grad():
        full, hidden, captured = port.language_model(input_ids=_t(ids).long(), capture_kv=True,
                                                     rope_len=CAP)
    logits = torch.cat([g[0] for g in got], dim=1)
    _close(logits, full, MODEL_TOL)
    _close(torch.cat([g[1] for g in got], dim=1), hidden, MODEL_TOL)
    n = PROMPT + STEPS
    assert captured.index == n and tuple(captured.k.shape) == (
        cfg.llm.num_hidden_layers, B, n, cfg.llm.num_key_value_heads, cfg.llm.head_dim)
    _close(cache.k[:, :, :n], captured.k, MODEL_TOL)
    _close(cache.v[:, :, :n], captured.v, MODEL_TOL)


def test_capture_kv_on_the_row_major_branch(pair):
    """The weight-only decoder captures from its row-major branch: the same
    layout, and a cache built from it serves a suffix pass."""
    _, _, params, cfg, tcfg = pair
    qparams, _ = jax_quantize_for_serving(params, Precision.fp32(), int8=True)
    tprec = serving_precision(TorchPrecision.fp32(), int8=True)
    port = TorchAssessor(tcfg, tprec)
    port.load_state_dict(state_dict_from_jax(jax.device_get(qparams), tcfg, tprec), strict=True)
    port.eval()
    ids = _t(np.random.default_rng(7).integers(5, cfg.llm.vocab_size, (B, 12))).long()
    with torch.no_grad():
        full, _, _ = port.language_model(input_ids=ids, rope_len=12)
        _, _, kv = port.language_model(input_ids=ids[:, :8], capture_kv=True, rope_len=12,
                                       with_logits=False)
        cache = TorchKVCache.from_prefix(kv.k, kv.v, 4)
        assert cache.index == 8 and cache.max_len == 12 and int(cache.index_dev) == 8
        tail, _, cache = port.language_model(input_ids=ids[:, 8:], cache=cache)
    _close(tail, full[:, 8:], MODEL_TOL)
    assert cache.index == 12
