"""K2's training forms on three tensors: the port's forward with logsumexp
and backward against JAX.

The plain versions (`plain_flash_attention(return_lse=True)`,
`plain_flash_attention_bwd`), which `FlashAttention` runs for CPU tensors and
which the CUDA kernels are held against on the card, against:

- `jax.grad` of the JAX package's `multi_head_attention` on its XLA path, and
  a logsumexp of the masked logits written in jax.numpy, fp32, atol = rtol =
  1e-4 (two softmax formulations, one summation order apart), in both
  layouts: MHA, GQA causal, a garbage tail beyond `kv_valid`, non-causal
  Sq != Skv, an odd head count;
- the Pallas kernels themselves (`_flash_fwd` with the logsumexp, then
  `_flash_bwd`'s dq and dk/dv kernels through the custom_vjp) in interpret
  mode at one tiny shape, fp32, atol = rtol = 2e-3, the tolerance
  tests/test_attention.py holds those kernels' gradients to;
- `torch.autograd.gradcheck` of `FlashAttention` in fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops.attention import multi_head_attention
from aigv_assessor_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_lse,
    plain_flash_attention,
    plain_flash_attention_bwd,
)
from aigv_assessor_tpu.ops.attention import multi_head_attention as jax_mha

TOL = 1e-4
PALLAS_TOL = 2e-3

# (B, Sq, Skv, hq, hkv, D, causal, kv_valid)
CASES = {
    "mha_noncausal": (2, 40, 40, 4, 4, 16, False, None),
    "gqa_causal": (2, 40, 40, 4, 2, 32, True, None),
    "kv_valid_garbage_tail": (1, 48, 48, 4, 4, 16, False, 35),
    "cross_sq_ne_skv": (2, 24, 40, 4, 2, 16, False, 33),
    "odd_heads": (1, 37, 37, 5, 5, 16, False, None),
}
PARAMS = [(name, layout) for name in CASES for layout in ("bshd", "bhsd")]


def _inputs(seed, case, layout):
    """q, k, v, dout as numpy fp32 in `layout`; k and v hold +-1e3 beyond
    kv_valid, which must be masked."""
    b, sq, skv, hq, hkv, d, _, kv_valid = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    if kv_valid is not None:
        k[:, kv_valid:], v[:, kv_valid:] = 1e3, -1e3
    dout = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    ts = (q, k, v, dout)
    if layout == "bhsd":
        ts = tuple(np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in ts)
    return ts


def _jax_lse(q, k, causal, kv_valid):
    """[B, Hq, Sq] logsumexp of the masked scaled logits, from bshd numpy."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", jnp.asarray(q).reshape(b, sq, hkv, g, d),
                        jnp.asarray(k)) * d**-0.5
    valid = jnp.ones((sq, skv), bool)
    if causal:
        valid = jnp.tril(valid)
    if kv_valid is not None:
        valid = valid & (jnp.arange(skv) < kv_valid)[None, :]
    logits = jnp.where(valid, logits, -jnp.inf)
    return jax.nn.logsumexp(logits, axis=-1).reshape(b, hq, sq)


@pytest.fixture(scope="module")
def jax_reference():
    """{(case, layout): (inputs, out, lse, (dq, dk, dv))} from JAX's XLA
    attention, computed once for the module's tests."""
    ref = {}
    for name, layout in PARAMS:
        case = CASES[name]
        causal, kv_valid = case[6], case[7]
        q, k, v, dout = _inputs(0, case, layout)
        kw = dict(causal=causal, impl="xla", layout=layout, kv_valid=kv_valid)

        def scalar(q_, k_, v_):
            return jnp.sum(jax_mha(q_, k_, v_, **kw) * dout)

        out = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        grads = jax.grad(scalar, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                     jnp.asarray(v))
        bshd = (lambda t: t) if layout == "bshd" else (lambda t: t.transpose(0, 2, 1, 3))
        lse = _jax_lse(bshd(q), bshd(k), causal, kv_valid)
        ref[(name, layout)] = ((q, k, v, dout), np.asarray(out), np.asarray(lse),
                               tuple(np.asarray(g) for g in grads))
    return ref


@pytest.mark.parametrize("name,layout", PARAMS)
def test_plain_forward_lse_and_backward_match_jax_xla(jax_reference, name, layout):
    case = CASES[name]
    kw = dict(causal=case[6], layout=layout, kv_valid=case[7])
    inputs, want_out, want_lse, want_grads = jax_reference[(name, layout)]
    q, k, v, dout = (torch.from_numpy(t) for t in inputs)
    out, lse = plain_flash_attention(q, k, v, return_lse=True, **kw)
    grads = plain_flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    for got, want, t in zip(grads, want_grads, (q, k, v)):
        assert got.shape == t.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    kv_valid = case[7]
    if kv_valid is not None:  # nothing flows back into the masked keys
        seq = 2 if layout == "bhsd" else 1
        for g in grads[1:]:
            assert not g.narrow(seq, kv_valid, g.shape[seq] - kv_valid).any()


def test_plain_versions_match_the_pallas_kernels_in_interpret_mode():
    """The forward with logsumexp (`_flash_fwd`), then the dq and dk/dv
    kernels through the custom_vjp (`_flash_bwd`), as tests/test_attention.py
    runs them on the CPU: GQA, a garbage tail beyond kv_valid, `bshd`."""
    from jax.experimental.pallas import tpu as pltpu

    from aigv_assessor_tpu.ops import pallas_attention as pa

    case = (1, 64, 64, 2, 1, 64, False, 50)
    _, sq, _, hq, _, d, causal, kv_valid = case
    q, k, v, dout = _inputs(1, case, "bshd")
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    kw = dict(causal=causal, layout="bshd", kv_valid=kv_valid)
    with pltpu.force_tpu_interpret_mode():
        want_out, res = pa._flash_fwd(jq, jk, jv, causal, d**-0.5, pa.DEFAULT_BLOCK_Q,
                                      pa.DEFAULT_BLOCK_K, "bshd", kv_valid)
        want_grads = jax.grad(
            lambda a, b_, c: jnp.sum(pa.flash_attention(a, b_, c, **kw) * dout),
            argnums=(0, 1, 2))(jq, jk, jv)
    want_lse = np.asarray(res[4])[:, :sq].reshape(1, hq, sq)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    out, lse = plain_flash_attention(tq, tk, tv, return_lse=True, **kw)
    grads = plain_flash_attention_bwd(tq, tk, tv, out, lse, tdo, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=PALLAS_TOL, atol=PALLAS_TOL)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PALLAS_TOL,
                                   atol=PALLAS_TOL)


@pytest.mark.parametrize("name", ["gqa_causal", "cross_sq_ne_skv"])
def test_autograd_function_on_cpu_runs_the_plain_versions(name):
    """`multi_head_attention` on tensors that need a gradient goes through
    `FlashAttention`: the output of the no-gradient call, the plain
    backward's gradients, and no kernel launch counted."""
    case = CASES[name]
    kw = dict(causal=case[6], kv_valid=case[7])
    q, k, v, dout = (torch.from_numpy(t) for t in _inputs(3, case, "bshd"))
    counters = (flash_attention, flash_attention_lse, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = multi_head_attention(*leaves, **kw)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(dout)
    with torch.no_grad():
        plain, lse = plain_flash_attention(q, k, v, return_lse=True, **kw)
        want = flash_attention_bwd(q, k, v, plain, lse, dout, **kw)
        torch.testing.assert_close(multi_head_attention(q, k, v, **kw), out, rtol=0, atol=0)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    for leaf, g in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("causal,kv_valid,sq,layout", [
    (False, 5, 7, "bshd"), (True, None, 7, "bhsd"), (False, None, 4, "bshd")])
def test_autograd_function_passes_gradcheck(causal, kv_valid, sq, layout):
    rng = np.random.default_rng(4)
    shapes = [(1, sq, 2, 4), (1, 7, 1, 4), (1, 7, 1, 4)]
    ts = [torch.from_numpy(rng.normal(size=s)) for s in shapes]  # fp64
    if layout == "bhsd":
        ts = [t.transpose(1, 2).contiguous() for t in ts]
    ts = [t.requires_grad_() for t in ts]
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, layout, kv_valid), ts,
        eps=1e-6, atol=1e-5, rtol=1e-4,
    )


def test_backward_rounds_p_and_ds_to_the_input_dtype():
    """In bf16 the plain backward rounds p and ds to bf16 before the dv, dq
    and dk products, as the CUDA kernels do; its gradients stay within bf16
    rounding (rtol = atol = 3e-2) of the fp32 gradients of the same inputs."""
    case = CASES["cross_sq_ne_skv"]
    kw = dict(causal=case[6], kv_valid=case[7])
    t16 = [torch.from_numpy(t).to(torch.bfloat16) for t in _inputs(5, case, "bshd")]
    out16, lse16 = plain_flash_attention(*t16[:3], return_lse=True, **kw)
    got = plain_flash_attention_bwd(*t16[:3], out16, lse16, t16[3], **kw)
    assert all(g.dtype == torch.bfloat16 for g in got) and lse16.dtype == torch.float32
    t32 = [t.float() for t in t16]
    out32, lse32 = plain_flash_attention(*t32[:3], return_lse=True, **kw)
    want = plain_flash_attention_bwd(*t32[:3], out32, lse32, t32[3], **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=3e-2, atol=3e-2)


def test_training_kernel_wrappers_are_cuda_only():
    case = CASES["mha_noncausal"]
    q, k, v, dout = (torch.from_numpy(t) for t in _inputs(7, case, "bshd"))
    out, lse = flash_attention_lse(q, k, v)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    # the dq entry reads out and writes delta; the dk/dv entry reads delta
    with pytest.raises(ValueError, match="runs on cuda"):
        flash_attention_bwd_dq(q, k, v, out, dout, lse, torch.empty_like(delta),
                               torch.empty_like(q))
    with pytest.raises(ValueError, match="runs on cuda"):
        flash_attention_bwd_dkv(q, k, v, dout, lse, delta, torch.empty_like(k),
                                torch.empty_like(v))
