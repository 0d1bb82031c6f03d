"""The plain attention that the card holds the forward kernel against, held
against the JAX package's plain attention at the kernel's tile borders.

`chip_smoke.py` and tests/test_torch_gpu.py compare the forward kernel (K1
off a fused qkv, K2 on three tensors) with `plain_attention_qkv` and
`plain_flash_attention` at the borders of its tiles. Here those two plain
versions meet the JAX package's XLA path (`fused_qkv_attention` and
`multi_head_attention` with `impl="xla"`, not the Pallas kernel in interpret
mode) on the same inputs from a numpy seed, in fp32 at atol = rtol = 1e-5:
one row, rows one short of and one past a tile, kv_valid = 1 and inside a
tile, causal at a ragged S, G = 6, and non-causal Sq > Skv and Sq < Skv.
Keys past kv_valid hold +-1e3, which the mask must keep out.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops.flash_attention import plain_attention_qkv, plain_flash_attention
from aigv_assessor_tpu.ops.attention import fused_qkv_attention, multi_head_attention

TOL = 1e-5

# (B, Sq, Skv, hq, hkv, D, causal, kv_valid)
EDGES = {
    "s1_causal_gqa": (2, 1, 1, 4, 2, 128, True, None),
    "s127_kv_in_tile": (1, 127, 127, 2, 2, 64, False, 100),
    "s129_causal": (1, 129, 129, 4, 2, 128, True, None),
    "s257_causal_g6": (1, 257, 257, 12, 2, 64, True, None),
    "kv_valid_1": (2, 129, 129, 2, 2, 64, False, 1),
    "sq_gt_skv": (2, 300, 129, 4, 2, 64, False, 100),
    "sq_lt_skv_g6": (1, 127, 257, 6, 1, 128, False, None),
}
SELF_EDGES = [name for name, case in EDGES.items() if case[1] == case[2]]


@pytest.fixture(scope="module")
def inputs():
    """q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D] in fp32 for every case."""
    rng = np.random.default_rng(40)
    made = {}
    for name, (b, sq, skv, hq, hkv, d, _, kv_valid) in EDGES.items():
        q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
        k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
        v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
        if kv_valid is not None:
            k[:, kv_valid:], v[:, kv_valid:] = 1e3, -1e3
        made[name] = (q, k, v)
    return made


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(EDGES))
def test_plain_flash_attention_matches_jax_at_tile_borders(inputs, name, layout):
    _, _, _, _, _, _, causal, kv_valid = EDGES[name]
    q, k, v = inputs[name]
    if layout == "bhsd":
        q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v))
    want = multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, layout=layout,
        kv_valid=kv_valid, impl="xla")
    got = plain_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        layout=layout, kv_valid=kv_valid)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("out_layout", ["bhsd", "bsd"])
@pytest.mark.parametrize("name", SELF_EDGES)
def test_plain_attention_qkv_matches_jax_at_tile_borders(inputs, name, out_layout):
    _, _, _, hq, hkv, _, causal, kv_valid = EDGES[name]
    qkv = np.concatenate([t.transpose(0, 2, 1, 3) for t in inputs[name]], axis=1)
    want = fused_qkv_attention(
        jnp.asarray(qkv), hq, hkv, causal=causal, kv_valid=kv_valid, impl="xla",
        out_layout=out_layout)
    got = plain_attention_qkv(
        torch.from_numpy(qkv), hq, hkv, causal=causal, kv_valid=kv_valid, out_layout=out_layout)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
