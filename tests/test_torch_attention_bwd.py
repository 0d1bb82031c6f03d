"""The port's attention forward-with-logsumexp and backward against JAX.

The plain versions (`plain_attention_qkv(return_lse=True)`,
`plain_attention_qkv_bwd`), which the wrappers and `FlashAttentionQKV` run
for CPU tensors and which the CUDA kernels are held against on the card,
against:

- `jax.grad` of the JAX package's `fused_qkv_attention` on its XLA path, and
  a logsumexp of the masked logits written in jax.numpy, fp32, atol = rtol =
  1e-4 (two softmax formulations, one summation order apart);
- the Pallas kernels themselves (forward with lse, dq and dk/dv kernels) in
  interpret mode at one tiny shape, fp32, atol = rtol = 2e-3, the tolerance
  tests/test_attention.py holds those kernels' gradients to;
- autograd through the plain forward, and `torch.autograd.gradcheck` in fp64.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops.attention import fused_qkv_attention
from aigv_assessor_torch.ops.flash_attention import (
    FlashAttentionQKV,
    flash_attention_qkv,
    flash_attention_qkv_bwd,
    flash_attention_qkv_bwd_kernel,
    flash_attention_qkv_lse,
    plain_attention_qkv,
    plain_attention_qkv_bwd,
)
from aigv_assessor_tpu.ops.attention import fused_qkv_attention as jax_fused

TOL = 1e-4
PALLAS_TOL = 2e-3

# (B, hq, hkv, S, D, causal, kv_valid)
CASES = {
    "mha_noncausal": (2, 4, 4, 40, 16, False, None),
    "gqa_causal": (2, 4, 2, 40, 32, True, None),
    "kv_valid_garbage_tail": (1, 4, 4, 48, 16, False, 35),
    "ragged_gqa_causal": (1, 6, 2, 37, 16, True, None),
}


def _inputs(seed, case):
    b, hq, hkv, s, d, _, kv_valid = case
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, hq + 2 * hkv, s, d)).astype(np.float32)
    if kv_valid is not None:  # garbage beyond kv_valid must be masked
        qkv[:, hq : hq + hkv, kv_valid:] = 1e3
        qkv[:, hq + hkv :, kv_valid:] = -1e3
    dout = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    return qkv, dout


def _jax_lse(qkv, hq, hkv, causal, kv_valid):
    b, _, s, d = qkv.shape
    g = hq // hkv
    q = jnp.asarray(qkv[:, :hq]).reshape(b, hkv, g, s, d)
    k = jnp.asarray(qkv[:, hq : hq + hkv])
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", q, k) * d**-0.5
    valid = jnp.ones((s, s), bool)
    if causal:
        valid = jnp.tril(valid)
    if kv_valid is not None:
        valid = valid & (jnp.arange(s) < kv_valid)[None, :]
    logits = jnp.where(valid, logits, -jnp.inf)
    return jax.nn.logsumexp(logits, axis=-1).reshape(b, hq, s)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_and_backward_match_jax_xla(name):
    case = CASES[name]
    _, hq, hkv, _, _, causal, kv_valid = case
    qkv, dout = _inputs(0, case)
    kw = dict(causal=causal, kv_valid=kv_valid)

    def scalar(x):
        return jnp.sum(jax_fused(x, hq, hkv, impl="xla", **kw) * dout)

    want_out = jax_fused(jnp.asarray(qkv), hq, hkv, impl="xla", **kw)
    want_grad = jax.grad(scalar)(jnp.asarray(qkv))

    t = torch.from_numpy(qkv)
    out, lse = plain_attention_qkv(t, hq, hkv, return_lse=True, **kw)
    got = plain_attention_qkv_bwd(t, out, lse, torch.from_numpy(dout), hq, hkv, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(_jax_lse(qkv, hq, hkv, causal, kv_valid)), rtol=TOL, atol=TOL
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want_grad), rtol=TOL, atol=TOL)
    if kv_valid is not None:  # nothing flows back into the masked keys
        assert not got[:, hq:, kv_valid:].any()


def test_plain_versions_match_the_pallas_kernels_in_interpret_mode():
    """Forward with lse, then the dq and dk/dv kernels through the
    custom_vjp, as tests/test_attention.py runs them on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    from aigv_assessor_tpu.ops import pallas_attention as pa

    case = (1, 2, 1, 64, 64, True, None)
    _, hq, hkv, s, d, causal, kv_valid = case
    qkv, dout = _inputs(1, case)
    with pltpu.force_tpu_interpret_mode():
        want_out, (_, _, want_lse) = pa._flash_qkv_fwd(
            jnp.asarray(qkv), hq, hkv, causal, d**-0.5, pa.CAUSAL_BLOCK_Q,
            pa.DEFAULT_BLOCK_K, kv_valid,
        )
        want_grad = jax.grad(
            lambda x: jnp.sum(pa.flash_attention_qkv(x, hq, hkv, causal=causal) * dout)
        )(jnp.asarray(qkv))
    t = torch.from_numpy(qkv)
    out, lse = plain_attention_qkv(t, hq, hkv, causal=causal, return_lse=True)
    got = plain_attention_qkv_bwd(t, out, lse, torch.from_numpy(dout), hq, hkv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=PALLAS_TOL, atol=PALLAS_TOL)
    np.testing.assert_allclose(
        lse.numpy().reshape(-1, s), np.asarray(want_lse)[:, :s], rtol=PALLAS_TOL, atol=PALLAS_TOL
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want_grad), rtol=PALLAS_TOL, atol=PALLAS_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_equals_autograd_through_plain_forward(name):
    case = CASES[name]
    _, hq, hkv, _, _, causal, kv_valid = case
    qkv, dout = _inputs(2, case)
    kw = dict(causal=causal, kv_valid=kv_valid)
    t = torch.from_numpy(qkv).requires_grad_()
    out = plain_attention_qkv(t, hq, hkv, **kw)
    (want,) = torch.autograd.grad(out, t, torch.from_numpy(dout))
    with torch.no_grad():
        out, lse = plain_attention_qkv(t, hq, hkv, return_lse=True, **kw)
        got = plain_attention_qkv_bwd(t, out, lse, torch.from_numpy(dout), hq, hkv, **kw)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["gqa_causal", "kv_valid_garbage_tail"])
def test_autograd_function_on_cpu_runs_the_plain_versions(name):
    """`FlashAttentionQKV` through the model-facing entry point: the output
    of the no-gradient call, the plain backward's gradient, and no kernel
    launch counted."""
    case = CASES[name]
    _, hq, hkv, _, _, causal, kv_valid = case
    qkv, dout = _inputs(3, case)
    kw = dict(causal=causal, kv_valid=kv_valid)
    counters = (flash_attention_qkv, flash_attention_qkv_lse, flash_attention_qkv_bwd_kernel)
    before = [c.launches for c in counters]
    t = torch.from_numpy(qkv).requires_grad_()
    out = fused_qkv_attention(t, hq, hkv, **kw)
    assert out.grad_fn is not None and "FlashAttentionQKV" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(dout))
    with torch.no_grad():
        plain, lse = plain_attention_qkv(t, hq, hkv, return_lse=True, **kw)
        want = flash_attention_qkv_bwd(t, plain, lse, torch.from_numpy(dout), hq, hkv, **kw)
        torch.testing.assert_close(fused_qkv_attention(t, hq, hkv, **kw), out, rtol=0, atol=0)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    torch.testing.assert_close(t.grad, want, rtol=0, atol=0)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("causal,kv_valid", [(False, 5), (True, None)])
def test_autograd_function_passes_gradcheck(causal, kv_valid):
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(1, 4, 7, 4))).requires_grad_()  # fp64
    assert torch.autograd.gradcheck(
        lambda x: FlashAttentionQKV.apply(x, 2, 1, causal, kv_valid), (qkv,),
        eps=1e-6, atol=1e-5, rtol=1e-4,
    )


def test_backward_rounds_p_and_ds_to_the_input_dtype():
    """In bf16 the plain backward rounds p and ds to bf16 before the dv, dq
    and dk products, as the CUDA kernels do; its gradient stays within bf16
    rounding (rtol = atol = 3e-2) of the fp32 gradient of the same inputs."""
    case = CASES["gqa_causal"]
    _, hq, hkv, _, _, causal, _ = case
    qkv, dout = _inputs(5, case)
    t16 = torch.from_numpy(qkv).to(torch.bfloat16)
    d16 = torch.from_numpy(dout).to(torch.bfloat16)
    out16, lse16 = plain_attention_qkv(t16, hq, hkv, causal=causal, return_lse=True)
    got = plain_attention_qkv_bwd(t16, out16, lse16, d16, hq, hkv, causal=causal)
    assert got.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    t32, d32 = t16.float(), d16.float()
    out32, lse32 = plain_attention_qkv(t32, hq, hkv, causal=causal, return_lse=True)
    want = plain_attention_qkv_bwd(t32, out32, lse32, d32, hq, hkv, causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)


def test_bsd_layout_is_forward_only():
    qkv = torch.from_numpy(_inputs(6, CASES["mha_noncausal"])[0]).requires_grad_()
    with pytest.raises(ValueError, match="forward-only"):
        flash_attention_qkv(qkv, 4, 4, out_layout="bsd")
    with torch.no_grad():  # without a gradient to take, bsd is served
        assert flash_attention_qkv(qkv, 4, 4, out_layout="bsd").shape == (2, 40, 64)


def test_backward_kernel_wrappers_are_cuda_only():
    case = CASES["mha_noncausal"]
    qkv, dout = (torch.from_numpy(a) for a in _inputs(7, case))
    out, lse = plain_attention_qkv(qkv, 4, 4, return_lse=True)
    delta = (dout * out).sum(-1)
    # the entry reads out and writes delta, then dq, dk and dv
    with pytest.raises(ValueError, match="runs on cuda"):
        flash_attention_qkv_bwd_kernel(qkv, out, dout, lse, torch.empty_like(delta),
                                       torch.empty_like(qkv), 4, 4)
