"""The plain causal attention that the card holds the forward kernel against,
at Qwen2-0.5B's heads (InternVL2-1B's decoder: 14 q heads over 2 kv heads of
64), against the JAX package's Pallas kernels in interpret mode.

The causal forward kernel (`csrc/flash_attn_fwd.cu`) aligns its q tiles of
192 rows to the end of the sequence, so that the ragged tile (S mod 192
rows) comes first and starts before row 0. On the card it is held against
`plain_attention_qkv` (K1) and `plain_flash_attention` (K2) at those
borders; here the same plain versions meet JAX's `flash_attention_qkv` and
`flash_attention` run in interpret mode, as tests/test_attention.py runs
them, at one row and at 193 rows (one row past a tile), B = 1, on the same
inputs from a numpy seed, in fp32 at atol = rtol = 1e-4 (the Pallas kernel's
online softmax against the plain version's one pass): K1 head-major (JAX's
dense `bsd` form takes no 64-wide heads under GQA), K2 in `bhsd` and
`bshd`. One module fixture runs JAX once per case.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_qkv,
    plain_attention_qkv,
    plain_flash_attention,
)

TOL = 1e-4
HQ, HKV, D = 14, 2, 64
ROWS = (1, 193)


@pytest.fixture(scope="module")
def cases():
    """For each S: the fused qkv [1, hq + 2 hkv, S, D] in fp32 and the
    Pallas kernels' outputs in interpret mode, K1 off the fused array and K2
    on its q, k, v in both layouts."""
    from jax.experimental.pallas import tpu as pltpu

    from aigv_assessor_tpu.ops.pallas_attention import flash_attention as jax_flash
    from aigv_assessor_tpu.ops.pallas_attention import flash_attention_qkv as jax_flash_qkv

    rng = np.random.default_rng(24)
    made = {}
    for s in ROWS:
        qkv = rng.normal(size=(1, HQ + 2 * HKV, s, D)).astype(np.float32)
        want = {}
        with pltpu.force_tpu_interpret_mode():
            want["fused"] = np.asarray(jax_flash_qkv(jnp.asarray(qkv), HQ, HKV, causal=True))
            for layout in ("bhsd", "bshd"):
                q, k, v = (jnp.asarray(t) for t in _separate(qkv, layout))
                want[layout] = np.asarray(jax_flash(q, k, v, causal=True, layout=layout))
        made[s] = qkv, want
    return made


def _separate(qkv, layout):
    """q, k and v of the fused array, head-major or [B, S, H, D]."""
    parts = qkv[:, :HQ], qkv[:, HQ : HQ + HKV], qkv[:, HQ + HKV :]
    if layout == "bshd":
        parts = (t.transpose(0, 2, 1, 3) for t in parts)
    return tuple(np.ascontiguousarray(t) for t in parts)


@pytest.mark.parametrize("s", ROWS)
def test_plain_fused_qkv_matches_pallas_at_qwen2_heads(cases, s):
    qkv, want = cases[s]
    t = torch.from_numpy(qkv)
    got = plain_attention_qkv(t, HQ, HKV, causal=True)
    assert tuple(got.shape) == want["fused"].shape == (1, HQ, s, D)
    np.testing.assert_allclose(got.numpy(), want["fused"], rtol=TOL, atol=TOL)
    # the wrapper on a CPU tensor is the plain version, uncounted
    before = flash_attention_qkv.launches
    torch.testing.assert_close(flash_attention_qkv(t, HQ, HKV, causal=True), got, rtol=0, atol=0)
    assert flash_attention_qkv.launches == before


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("s", ROWS)
def test_plain_separate_matches_pallas_at_qwen2_heads(cases, s, layout):
    qkv, want = cases[s]
    q, k, v = (torch.from_numpy(t) for t in _separate(qkv, layout))
    got = plain_flash_attention(q, k, v, causal=True, layout=layout)
    assert tuple(got.shape) == want[layout].shape == tuple(q.shape)
    np.testing.assert_allclose(got.numpy(), want[layout], rtol=TOL, atol=TOL)
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v, causal=True, layout=layout), got,
                               rtol=0, atol=0)
    assert flash_attention.launches == before
