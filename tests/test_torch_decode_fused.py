"""The fused decode attention's plain path and the quantize feeds' quotient,
on the CPU.

- `plain_cached_decode_attention` (the window and the current token in one
  fp32 softmax, the fused kernel's plain version) against JAX's
  `cached_decode_attention` with its Pallas kernel in interpret mode (blocks
  of 16 rows, so windows start and end inside blocks), fp32 on both sides, at
  2e-5 (the JAX tests' own bound for the merged output): every window shape,
  an empty window (which gives v_new exactly) and no mask; head dims 64, 96
  and 128, one to seven query heads per kv head.
- The pieces and the form of the kernel's launch at the decode steps'
  shapes on 132 SMs.
- The wrapper on CPU tensors is that plain version and counts no launch.
- The decoder computes the windows' first rows once per step, and its
  logits are those of a decoder whose attention computes them per layer.
- The quantize kernels' quotient: a float32 model of the kernel's shortcut
  (y * (1/s) rounded with 1.5 * 2^23, the IEEE quotient where the product
  lies within 2^-15 of a half-integer) equals clip(rint(y / s)) bit for bit
  over 10^6 seeded values and over the adversarial ones: exact halves
  (k + 1/2) s and their neighbours 1-4 ulps away, the smallest scale, and
  y = +-absmax. numpy rounds float32 products, sums and quotients as
  __fmul_rn, __fadd_rn and __fdiv_rn do.
- `tools/quant_fuse_ab.tie_grid`, the card's tie-grid test, gives the plain
  versions' own answer for every producer.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import LLMConfig as TorchLLMConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models import internlm2 as t_llm
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import KVCache as TorchKVCache
from aigv_assessor_torch.models.loading import init_random_
from aigv_assessor_torch.ops import decode_attention as t_dec
from aigv_assessor_torch.ops import quant_fuse as qf
from aigv_assessor_torch.tools import quant_fuse_ab
from aigv_assessor_tpu.ops.decode_attention import cached_decode_attention as j_cached

TOL = 2e-5

DECODE = {
    # name: (b, hq, hkv, d, max_len, end, starts)
    "full_window_d128": (2, 8, 4, 128, 64, 37, (0, 0)),
    "ragged_starts_d128": (3, 16, 8, 128, 64, 48, (0, 17, 40)),
    "gqa_8_over_2_d64": (2, 8, 2, 64, 56, 55, (0, 9)),
    "mha_d64_end_off_block": (2, 8, 8, 64, 56, 17, (3, 16)),
    "empty_cache": (2, 8, 4, 64, 32, 0, (0, 0)),
    "one_row_window": (2, 16, 8, 128, 32, 20, (19, 0)),
    "start_past_end": (2, 8, 4, 64, 40, 12, (12, 30)),
    # one query head per kv head at D = 96 (Phi-3-mini), windows that start
    # and end inside a 16-row block; seven per kv head (Qwen2-0.5B's 14 / 2)
    "mha_d96": (2, 8, 8, 96, 56, 37, (0, 9)),
    "gqa_14_over_2_d64": (2, 14, 2, 64, 56, 55, (3, 0)),
}


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _inputs(name):
    b, hq, hkv, d, max_len, end, starts = DECODE[name]
    rng = np.random.default_rng(100 + len(name))
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, 1, hkv, d)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.normal(size=(b, max_len, hkv, d)).astype(np.float32) for _ in range(2))
    kv_mask = np.ones((b, max_len), bool)
    for i, st in enumerate(starts):
        kv_mask[i, :st] = False
    return q, k, v, ck, cv, kv_mask, np.asarray(starts, np.int32), end


@pytest.mark.parametrize("name", list(DECODE))
def test_plain_cached_decode_attention_matches_jax_kernel(name):
    q, k, v, ck, cv, kv_mask, starts, end = _inputs(name)
    want = j_cached(*(jnp.asarray(a) for a in (q, k, v, ck, cv)), jnp.asarray(end, jnp.int32),
                    jnp.asarray(kv_mask), blk=16, interpret=True)
    got = t_dec.plain_cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), end,
                                              _t(kv_mask))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # `starts` handed in gives the same as the mask it comes from
    given = t_dec.plain_cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), end,
                                                starts=_t(starts))
    assert torch.equal(given, got)
    if end == 0:  # nothing in the window: the current token's v, exactly
        hq, hkv = q.shape[2], k.shape[2]
        assert torch.equal(got[:, 0], _t(v)[:, 0].repeat_interleave(hq // hkv, dim=1))
    if not starts.any():  # no mask: every window starts at row 0
        want0 = j_cached(*(jnp.asarray(a) for a in (q, k, v, ck, cv)),
                         jnp.asarray(end, jnp.int32), None, blk=16, interpret=True)
        nomask = t_dec.plain_cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), end)
        np.testing.assert_allclose(nomask.numpy(), np.asarray(want0), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(DECODE))
def test_cpu_wrapper_is_the_plain_version(name):
    q, k, v, ck, cv, kv_mask, starts, end = _inputs(name)
    before = (t_dec.cached_decode_attention.launches, t_dec.decode_attention.launches)
    got = t_dec.cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), torch.tensor(end),
                                        _t(kv_mask))
    want = t_dec.plain_cached_decode_attention(_t(q), _t(k), _t(v), _t(ck), _t(cv), end,
                                               _t(kv_mask))
    assert torch.equal(got, want)
    assert (t_dec.cached_decode_attention.launches, t_dec.decode_attention.launches) == before
    # the window alone and merge_new_token give the same function
    old = t_dec.decode_attention(_t(q[:, 0]), _t(ck), _t(cv), _t(starts), end)
    merged = t_dec.merge_new_token(*old, _t(q[:, 0]), _t(k), _t(v))
    np.testing.assert_allclose(merged.numpy(), got[:, 0].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batch, hkv, want", [
    (4, 32, (1, True)),  # Phi-3-mini's decode step: 128 (kv head, sample) pairs
    (4, 8, (7, False)),  # the 2B decode step
    (16, 8, (1, True)),  # the 2B step at B = 16: 128 pairs again
    (4, 2, (16, False)),  # Qwen2-0.5B's 2 kv heads
    (5, 32, (1, False)),  # 160 pairs: more than the SMs, two blocks an SM
])
def test_decode_launch_form_on_132_sms(batch, hkv, want):
    """The pieces and the form the wrapper picks for a cache of 2177 rows on
    an H100's 132 SMs."""
    nsplit = t_dec._splits(batch, hkv, 2177, 132)
    assert (nsplit, t_dec._wide(batch, hkv, nsplit, 132)) == want


def test_window_starts_are_the_first_attended_rows():
    mask = torch.tensor([[True] * 6, [False, False, True, True, True, True], [False] * 6])
    assert t_dec.window_starts(mask, 3, torch.device("cpu")).tolist() == [0, 2, 0]
    got = t_dec.window_starts(None, 2, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.tolist() == [0, 0]


def test_decoder_computes_starts_once_per_step():
    """8 query heads of D = 64 reach the decode path; the starts the decoder
    computes once per step give the logits of per-layer starts, bit for bit."""
    llm = dataclasses.replace(TorchLLMConfig.tiny(), hidden_size=512, num_attention_heads=8,
                              num_key_value_heads=2)
    cfg = TorchConfig.tiny(stage=2).replace(llm=llm, img_context_token_id=7)
    model = init_random_(TorchAssessor(cfg, TorchPrecision.fp32()), seed=0).eval()
    ids = torch.as_tensor(np.random.default_rng(3).integers(5, llm.vocab_size, (2, 12)))
    kv_mask = torch.ones((2, 16), dtype=torch.bool)
    kv_mask[1, :3] = False  # a left-padded row
    calls = []

    def counted(*args):
        calls.append(1)
        return t_dec.window_starts(*args)

    def run():
        cache = TorchKVCache.init(llm, 2, 16)
        with torch.no_grad():
            _, _, cache = model.prefill(model.embed_tokens(ids[:, :9]), cache, kv_mask=kv_mask)
            outs = []
            for i in range(9, 12):
                logits, _, cache = model.decode_step(ids[:, i : i + 1], cache, kv_mask)
                outs.append(logits)
        return torch.cat(outs, dim=1)

    with mock.patch.object(t_llm, "window_starts", counted):
        once = run()
    assert len(calls) == 3  # one per decode step, none in the prefill
    with mock.patch.object(t_llm, "window_starts", lambda *args: None):
        per_layer = run()  # each layer's attention derives them from kv_mask
    assert torch.equal(once, per_layer)


# ------------------------------------------------- the quotient shortcut ---

MAGIC = np.float32(12582912.0)  # 1.5 * 2^23
FAST_LIMIT = np.float32(0.5 - 2.0**-15)


def shortcut(y: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The kernel's `quant_byte` in float32 -> int8."""
    inv = np.float32(1.0) / s
    t = y * inv
    big = t + MAGIC
    fast = np.abs(t - (big - MAGIC)) < FAST_LIMIT
    low = (big.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return np.where(fast, low, reference(y, s))


def reference(y: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The division the kernel computed before: fminf(fmaxf(rintf(y / s),
    -127), 127), which clips a NaN to -127 as fmaxf does."""
    with np.errstate(invalid="ignore"):
        return np.fmin(np.fmax(np.rint(y / s), -127), 127).astype(np.int8)


def row_scale(y: np.ndarray) -> np.ndarray:
    """s = max(absmax, 1e-8) / 127 per row, in float32 as the kernel has it."""
    amax = np.abs(y).max(axis=-1, keepdims=True)
    return np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)


def test_quotient_shortcut_on_seeded_values():
    rng = np.random.default_rng(0)
    # rows of 1000 at scales from 1e-12 to 1e6, heavy tails besides
    scales = np.float32(10.0) ** rng.uniform(-12, 6, size=(1000, 1)).astype(np.float32)
    y = (rng.standard_normal((1000, 1000)) * scales).astype(np.float32)
    y[::7] = rng.standard_cauchy((len(y[::7]), 1000)).astype(np.float32)
    s = row_scale(y)
    got, want = shortcut(y, s), reference(y, s)
    np.testing.assert_array_equal(got, want)
    assert y.size >= 10**6


@pytest.mark.parametrize("amax", [127.0, 1.0, 3.7e-3, 5e-9, 2.9e4, 0.0078125])
def test_quotient_shortcut_at_halves_and_their_neighbours(amax):
    s = row_scale(np.float32([[amax]]))
    k = np.arange(-127, 127, dtype=np.float64) + 0.5
    halves = (k * np.float64(s[0, 0])).astype(np.float32)
    near = [halves]
    for n in range(1, 5):  # 1-4 ulps to either side
        up, down = halves.copy(), halves.copy()
        for _ in range(n):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
        near += [up, down]
    y = np.concatenate(near + [np.float32([amax, -amax, 0.0, -0.0])])
    y = y[np.abs(y) <= np.float32(amax)][None]  # |y| <= absmax, as in the kernel
    s = np.broadcast_to(s, y.shape)
    np.testing.assert_array_equal(shortcut(y, s), reference(y, s))
    # the exact halves really are ties of the division, so the slow path ran
    ties = np.abs(y / s - np.rint(y / s)) == 0.5
    assert ties.any() or amax < 1e-8


def test_quotient_shortcut_takes_the_division_where_it_must():
    """A tie (k + 1/2 exactly) goes to the division and rounds to even; a
    NaN gives the division's clipped NaN."""
    y = np.float32([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, np.nan]])
    s = np.float32([[1.0]])
    assert shortcut(y, np.broadcast_to(s, y.shape)).tolist() == [[0, 2, 2, 0, -2, 127, -127]]


@pytest.mark.parametrize("producer", quant_fuse_ab.PRODUCERS)
def test_tie_grid_is_the_plain_versions_answer(producer):
    x, extra, eps, q, s = quant_fuse_ab.tie_grid(producer, "cpu", rows=8)
    plain = {"identity": lambda: qf.plain_quant_rows(x),
             "layernorm": lambda: qf.plain_layernorm_quant(x, *extra, eps),
             "gelu": lambda: qf.plain_gelu_quant(x),
             "rmsnorm": lambda: qf.plain_rmsnorm_quant(x, *extra, eps),
             "silu_mul": lambda: qf.plain_silu_mul_quant(x, *extra)}[producer]
    got_q, got_s = plain()
    assert torch.equal(got_q, q) and torch.equal(got_s, s)
    # every value lies on a tie or an integer of y / s
    assert ((q.abs() <= 127) & (q != 0)).float().mean() > 0.3
