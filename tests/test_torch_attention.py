"""The port's attention against the JAX package.

The port's plain fused-qkv attention (the plain version of the CUDA kernel,
which the wrapper runs for CPU tensors) is held against the Pallas kernel
`flash_attention_qkv` run in interpret mode, as tests/test_attention.py runs
it, in fp32 at atol/rtol 1e-4, in both output layouts (head-major `bhsd`
and dense `bsd`).

The plain three-tensor attention (`plain_flash_attention`, what
`flash_attention` and `multi_head_attention` run for CPU tensors) is held
against the Pallas kernel `flash_attention` in interpret mode and against
`xla_attention`, in fp32 at 1e-5: `bshd` and `bhsd`, GQA, causal, non-causal
with Sq != Skv, `kv_valid`, D = 64 and 128.

The kernels themselves are tested on the card in tests/test_torch_gpu.py.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops.attention import (
    fused_qkv_attention,
    multi_head_attention,
    plain_attention,
)
from aigv_assessor_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_qkv,
    plain_attention_qkv,
    plain_flash_attention,
)
from aigv_assessor_tpu.ops.attention import multi_head_attention as jax_multi_head_attention
from aigv_assessor_tpu.ops.attention import xla_attention

TOL = 1e-4


def _fused(seed, b, hq, hkv, s, d, kv_valid=None):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, hq + 2 * hkv, s, d)).astype(np.float32)
    if kv_valid is not None:  # garbage beyond kv_valid must be masked
        qkv[:, hq : hq + hkv, kv_valid:] = 1e3
        qkv[:, hq + hkv :, kv_valid:] = -1e3
    return qkv


FUSED_CASES = [
    # the ViT's form: non-causal MHA, D=64, a garbage tail past kv_valid
    dict(causal=False, hq=4, hkv=4, d=64, s=200, kv_valid=150),
    # the LLM's form: causal GQA, D=128, S not a tile multiple
    dict(causal=True, hq=4, hkv=2, d=128, s=200, kv_valid=None),
]
FUSED_IDS = ["mha_d64_kv_valid", "gqa_causal_d128"]


@pytest.mark.parametrize("case", FUSED_CASES, ids=FUSED_IDS)
def test_plain_fused_qkv_matches_pallas_interpret(case):
    from jax.experimental.pallas import tpu as pltpu

    from aigv_assessor_tpu.ops.pallas_attention import flash_attention_qkv as jax_flash

    qkv = _fused(7, 2, case["hq"], case["hkv"], case["s"], case["d"], case["kv_valid"])
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(
            jnp.asarray(qkv), case["hq"], case["hkv"], causal=case["causal"],
            kv_valid=case["kv_valid"],
        )
    got = plain_attention_qkv(
        torch.from_numpy(qkv), case["hq"], case["hkv"], causal=case["causal"],
        kv_valid=case["kv_valid"],
    )
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", FUSED_CASES, ids=FUSED_IDS)
def test_plain_fused_qkv_bsd_matches_pallas_interpret(case):
    """The dense `bsd` output [B, S, hq*D] that the W8A8 out-projections
    read, against the Pallas kernel's `dense_out` form, and equal to the
    `bhsd` output transposed."""
    from jax.experimental.pallas import tpu as pltpu

    from aigv_assessor_tpu.ops.pallas_attention import flash_attention_qkv as jax_flash

    hq, hkv, s, d = case["hq"], case["hkv"], case["s"], case["d"]
    qkv = _fused(8, 2, hq, hkv, s, d, case["kv_valid"])
    kw = dict(causal=case["causal"], kv_valid=case["kv_valid"])
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(jnp.asarray(qkv), hq, hkv, out_layout="bsd", **kw)
    got = plain_attention_qkv(torch.from_numpy(qkv), hq, hkv, out_layout="bsd", **kw)
    assert tuple(got.shape) == want.shape == (2, s, hq * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    bhsd = plain_attention_qkv(torch.from_numpy(qkv), hq, hkv, **kw)
    torch.testing.assert_close(got, bhsd.transpose(1, 2).reshape(2, s, hq * d), rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_xla_attention(causal):
    """`plain_attention` is the counterpart of `xla_attention`: GQA, causal
    with a decode offset (Sq < Skv), and a boolean key mask."""
    rng = np.random.default_rng(1)
    b, sq, skv, hq, hkv, d = 2, 5, 9, 8, 2, 16
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    mask = rng.random((b, sq, skv)) > 0.3
    mask[:, :, -1] = True  # every row keeps a key
    got = plain_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, mask=torch.from_numpy(mask),
    )
    want = xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=jnp.asarray(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    """On a CPU tensor the kernel wrapper (and the model-facing dispatch) is
    the plain version, and no kernel launch is counted."""
    qkv = torch.from_numpy(_fused(3, 1, 4, 2, 40, 64))
    before = flash_attention_qkv.launches
    want = plain_attention_qkv(qkv, 4, 2, causal=True)
    torch.testing.assert_close(flash_attention_qkv(qkv, 4, 2, causal=True), want)
    torch.testing.assert_close(fused_qkv_attention(qkv, 4, 2, causal=True), want)
    assert flash_attention_qkv.launches == before


def test_plain_version_reads_a_strided_view():
    """The ViT hands the wrapper a head-major view of its [B, N, 3H*D]
    projection output; reading it must equal reading a contiguous copy."""
    rng = np.random.default_rng(5)
    b, n, h, d = 2, 24, 4, 64
    proj = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    view = proj.view(b, n, 3 * h, d).transpose(1, 2)
    assert not view.is_contiguous()
    torch.testing.assert_close(
        plain_attention_qkv(view, h, h, kv_valid=17),
        plain_attention_qkv(view.contiguous(), h, h, kv_valid=17),
    )


def test_wrapper_rejects_other_devices():
    qkv = torch.empty((1, 3, 16, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_qkv(qkv, 1, 1)


def test_plain_version_rejects_an_unknown_layout():
    qkv = torch.from_numpy(_fused(3, 1, 2, 2, 16, 64))
    with pytest.raises(ValueError, match="out_layout"):
        plain_attention_qkv(qkv, 2, 2, out_layout="bshd")


# ------------------------------------------------- three separate tensors ---

SEP_TOL = 1e-5
# (Sq, Skv, hq, hkv, D, causal, kv_valid)
SEPARATE = {
    "gqa_causal_d128": (72, 72, 4, 2, 128, True, None),
    "mha_tail_d64": (72, 72, 4, 4, 64, False, 50),
    "cross_d64": (40, 104, 4, 4, 64, False, None),
    "cross_gqa_tail_d128": (24, 88, 4, 2, 128, False, 81),
}


def _separate(case, layout, seed=11):
    sq, skv, hq, hkv, d, _, kv_valid = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(2, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, skv, hkv, d)).astype(np.float32)
    if kv_valid is not None:  # garbage beyond kv_valid must be masked
        k[:, kv_valid:], v[:, kv_valid:] = 1e3, -1e3
    if layout == "bhsd":
        q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(SEPARATE))
def test_plain_flash_attention_matches_pallas_interpret(name, layout):
    from jax.experimental.pallas import tpu as pltpu

    from aigv_assessor_tpu.ops.pallas_attention import flash_attention as jax_flash

    case = SEPARATE[name]
    q, k, v = _separate(case, layout)
    kw = dict(causal=case[5], layout=layout, kv_valid=case[6])
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = plain_flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), **kw)
    assert tuple(got.shape) == want.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SEP_TOL, atol=SEP_TOL)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(SEPARATE))
def test_multi_head_attention_matches_jax_dispatch(name, layout):
    """`multi_head_attention` on CPU tensors against the JAX entry point on
    the CPU (`xla_attention` behind the same layout and kv_valid handling),
    without a kernel launch counted."""
    case = SEPARATE[name]
    q, k, v = _separate(case, layout, seed=12)
    kw = dict(causal=case[5], layout=layout, kv_valid=case[6])
    want = jax_multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    before = flash_attention.launches
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = multi_head_attention(tq, tk, tv, **kw)
    assert flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SEP_TOL, atol=SEP_TOL)
    torch.testing.assert_close(flash_attention(tq, tk, tv, **kw), got, rtol=0, atol=0)


def test_three_tensor_wrapper_rejects():
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="layout"):
        plain_flash_attention(*(torch.zeros(1, 8, 2, 16),) * 3, layout="sbhd")
