"""The port's fp8 (e4m3) decode matmul against the JAX probe, on the CPU.

- `quantize_weight_fp8` bit for bit (as uint8) against the probe's
  `jnp.asarray(wf / scale, jnp.float8_e4m3fn)` on the transposed array, each
  channel's absmax element included (its quotient lands within an fp32
  rounding of 448), with no NaN byte (0x7F / 0xFF); the scales equal.
- `plain_fp8_matmul` against the probe's Pallas `fp8_matmul` in interpret
  mode (`pltpu.force_tpu_interpret_mode()`, as tests/test_int8.py runs the
  JAX kernels) with `out_dtype=float32`, at M = 1, 3, 8, K not a multiple of
  `block_k` and a ragged N: within 1e-5 relative (the same fp32 products,
  summed in another order). x holds bf16 values in fp32, since XLA:CPU has no
  bf16 dot; the port's plain version gives the same bits from the bf16 x.
- The wrapper on a CPU tensor is the plain version and counts no launch
  (it launched no kernel); `fp8_dense_apply` keeps leading dims; malformed
  operands raise.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aigv_assessor_torch.ops import fp8_matmul as f8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "fp8_decode_probe", os.path.join(REPO, "benchmarks", "fp8_decode_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_quantize(wf: np.ndarray):
    """The probe's quantizer (`benchmarks/fp8_decode_probe.py:136-140`) on a
    [K, N] leaf -> (e4m3 bytes [K, N] uint8, fp32 scale [N])."""
    ax = np.abs(wf).max(axis=0)
    scale = np.maximum(ax, 1e-8) / 448.0
    w_fp8 = jnp.asarray(wf / scale, jnp.float8_e4m3fn)
    return np.asarray(w_fp8).view(np.uint8), scale.astype(np.float32)


def weight(k: int, n: int, seed: int) -> np.ndarray:
    """[K, N] normal(0, 0.02), with an all-zero channel, a channel of tiny
    values (e4m3 subnormals after scaling) and one of large values."""
    rng = np.random.default_rng(seed)
    wf = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    wf[:, 0] = 0.0
    wf[:, 1] *= 1e-4
    wf[:, 2] *= 1e4
    wf[rng.integers(0, k), 3] = 0.5  # one outlier: the rest of its channel scales small
    return wf


@pytest.mark.parametrize("shape", [(256, 384), (300, 200), (2048, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_quantizer_is_bit_equal_to_the_probe(shape):
    k, n = shape
    wf = weight(k, n, seed=k + n)
    want_bytes, want_scale = probe_quantize(wf)
    w8, scale = f8.quantize_weight_fp8(torch.from_numpy(np.ascontiguousarray(wf.T)))
    assert w8.dtype == torch.float8_e4m3fn and tuple(w8.shape) == (n, k)
    got = w8.view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want_bytes.T)
    np.testing.assert_array_equal(scale.numpy(), want_scale)
    assert not np.isin(got, (0x7F, 0xFF)).any()  # e4m3fn's NaN encodings
    # each channel's absmax element is the largest finite value, +-448
    absmax = np.abs(wf).argmax(axis=0)
    top = got[np.arange(n), absmax] & 0x7F
    assert (top[1:] == 0x7E).all() and top[0] == 0  # channel 0 is all zero
    deq = f8.dequantize_weight_fp8(w8, scale).numpy()
    assert np.abs(deq - wf.T).max() <= np.abs(wf).max() * 2.0 ** -4


@pytest.fixture(scope="module")
def probe_outputs(probe):
    """The probe's Pallas kernel in interpret mode at each case, fp32 out."""
    out = {}
    for m in CASE_ROWS:
        k, n = CASE_KN
        x, wf = case_inputs(m)
        w_bytes, scale = probe_quantize(wf)
        w_fp8 = jnp.asarray(w_bytes).view(jnp.float8_e4m3fn)
        with pltpu.force_tpu_interpret_mode():
            y = probe.fp8_matmul(jnp.asarray(x), w_fp8, jnp.asarray(scale),
                                 block_k=CASE_BLOCK_K, out_dtype=jnp.float32)
        out[m] = np.asarray(y)
    return out


CASE_ROWS = (1, 3, 8)
CASE_KN = (300, 200)  # K = 300 is no multiple of block_k; N pads to 256
CASE_BLOCK_K = 128


def case_inputs(m: int):
    rng = np.random.default_rng(50 + m)
    k, n = CASE_KN
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    x = x.to(torch.bfloat16).float().numpy()  # bf16 values, held in fp32
    return x, weight(k, n, seed=m)


@pytest.mark.parametrize("m", CASE_ROWS)
def test_plain_version_matches_the_probe_kernel(probe_outputs, m):
    x, wf = case_inputs(m)
    w8, scale = f8.quantize_weight_fp8(torch.from_numpy(np.ascontiguousarray(wf.T)))
    got = f8.plain_fp8_matmul(torch.from_numpy(x), w8, scale, out_dtype=torch.float32)
    want = probe_outputs[m]
    assert got.shape == want.shape == (m, CASE_KN[1])
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= REL_TOL
    # the bf16 x gives the same fp32 sums: every product is exact in fp32
    got_bf16 = f8.plain_fp8_matmul(torch.from_numpy(x).to(torch.bfloat16), w8, scale,
                                   out_dtype=torch.float32)
    torch.testing.assert_close(got_bf16, got, atol=0, rtol=0)
    # the default output is that sum rounded to bf16 once
    y = f8.plain_fp8_matmul(torch.from_numpy(x).to(torch.bfloat16), w8, scale)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, got.to(torch.bfloat16), atol=0, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    x, wf = case_inputs(3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w8, scale = f8.quantize_weight_fp8(torch.from_numpy(np.ascontiguousarray(wf.T)))
    before = f8.fp8_matmul.launches
    got = f8.fp8_matmul(xb, w8, scale)
    assert f8.fp8_matmul.launches == before  # CPU tensors: no kernel launched
    torch.testing.assert_close(got, f8.plain_fp8_matmul(xb, w8, scale), atol=0, rtol=0)
    lead = f8.fp8_dense_apply(xb.repeat(4, 1).view(2, 6, -1), w8, scale)
    assert lead.shape == (2, 6, w8.shape[0])
    torch.testing.assert_close(lead.view(12, -1)[:3], got, atol=0, rtol=0)
    with pytest.raises(ValueError, match="w8"):
        f8.fp8_matmul(xb, w8.view(torch.uint8), scale)
    with pytest.raises(ValueError, match="w8"):
        f8.fp8_matmul(xb[:, :-1], w8, scale)
    with pytest.raises(ValueError, match="scale"):
        f8.fp8_matmul(xb, w8, scale.double())
    with pytest.raises(ValueError, match="x"):
        f8.fp8_matmul(xb[0], w8, scale)
