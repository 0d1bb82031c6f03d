"""The plain backward that the card holds the backward kernels against, held
against `jax.grad` of the JAX package's attention at the kernels' tile
borders.

`chip_smoke.py` and tests/test_torch_gpu.py compare the Hopper backward
kernel (one block per key tile of 128, 64 per warpgroup, over q tiles of 64
rows; dQ summed over the key tiles) with `plain_attention_qkv_bwd` and
`plain_flash_attention_bwd`. Here those two plain versions meet `jax.grad`
of the JAX package's XLA path (`fused_qkv_attention` and
`multi_head_attention` with `impl="xla"`, in both layouts) on the same fp32
inputs from a numpy seed, at atol = rtol = 1e-4 (two softmax formulations,
one summation order apart; tests/test_torch_attention_bwd.py's TOL): one
row, rows one short of and one past each tile, causal at a ragged S, G = 6
and 7, kv_valid = 1, inside a tile and one past the last full tile (1025 of
1032), and non-causal Sq > Skv and Sq < Skv. Keys past kv_valid hold +-1e3,
which the mask must keep out of every gradient.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops.flash_attention import (
    plain_attention_qkv,
    plain_attention_qkv_bwd,
    plain_flash_attention,
    plain_flash_attention_bwd,
)
from aigv_assessor_tpu.ops.attention import fused_qkv_attention, multi_head_attention

TOL = 1e-4

# (B, Sq, Skv, hq, hkv, D, causal, kv_valid)
EDGES = {
    "s1_causal_gqa": (2, 1, 1, 4, 2, 64, True, None),
    "s63": (1, 63, 63, 2, 2, 64, False, None),
    "s65_causal": (1, 65, 65, 4, 2, 128, True, None),
    "s127_kv_in_tile": (1, 127, 127, 2, 2, 64, False, 100),
    "s129_causal_g6": (1, 129, 129, 6, 1, 64, True, None),
    "s191_causal": (1, 191, 191, 4, 2, 64, True, None),
    "s193_kv65": (1, 193, 193, 2, 2, 64, False, 65),
    "kv_valid_1": (2, 129, 129, 2, 2, 64, False, 1),
    "sq_gt_skv": (2, 300, 129, 4, 2, 64, False, 100),
    "sq_lt_skv_g6": (1, 63, 257, 6, 1, 128, False, 200),
    # the one-kernel backward's 128-key tiles: Skv one short of, one past and
    # one past two tiles; the ViTs' kv_valid 1025 of 1032 (one valid key in
    # the last tile) at D = 64 and 128; Qwen2-0.5B's 14 / 2 heads causal
    "skv127": (1, 100, 127, 4, 2, 64, False, None),
    "skv129": (1, 100, 129, 2, 2, 128, False, None),
    "s257": (1, 257, 257, 2, 2, 128, False, None),
    "kv1025_d64": (1, 1032, 1032, 1, 1, 64, False, 1025),
    "kv1025_d128": (1, 1032, 1032, 1, 1, 128, False, 1025),
    "s193_causal_g7": (1, 193, 193, 14, 2, 64, True, None),
}
SELF_EDGES = [name for name, case in EDGES.items() if case[1] == case[2]]


def _inputs(name):
    """q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D] and dout in fp32."""
    b, sq, skv, hq, hkv, d, _, kv_valid = EDGES[name]
    rng = np.random.default_rng(50 + list(EDGES).index(name))
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    if kv_valid is not None:
        k[:, kv_valid:], v[:, kv_valid:] = 1e3, -1e3
    dout = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    return q, k, v, dout


def _head_major(*ts):
    return tuple(np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in ts)


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of <attention, dout> for every case: on three tensors in both
    layouts, and off the fused qkv where Sq == Skv."""
    made = {}
    for name, (_, _, _, hq, hkv, _, causal, kv_valid) in EDGES.items():
        q, k, v, dout = _inputs(name)
        for layout in ("bshd", "bhsd"):
            ts = (q, k, v, dout) if layout == "bshd" else _head_major(q, k, v, dout)

            def scalar(q_, k_, v_, dout_=jnp.asarray(ts[3]), layout=layout):
                out = multi_head_attention(q_, k_, v_, causal=causal, layout=layout,
                                           kv_valid=kv_valid, impl="xla")
                return jnp.sum(out * dout_)

            made[name, layout] = jax.jit(jax.grad(scalar, argnums=(0, 1, 2)))(
                *(jnp.asarray(t) for t in ts[:3]))
        if name in SELF_EDGES:
            qkv = np.concatenate(_head_major(q, k, v), axis=1)
            dout_hm = jnp.asarray(_head_major(dout)[0])
            made[name, "qkv"] = jax.jit(jax.grad(lambda x: jnp.sum(fused_qkv_attention(
                x, hq, hkv, causal=causal, kv_valid=kv_valid, impl="xla") * dout_hm)))(
                    jnp.asarray(qkv))
    return made


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(EDGES))
def test_plain_flash_attention_bwd_matches_jax_at_tile_borders(jax_grads, name, layout):
    _, sq, skv, _, _, _, causal, kv_valid = EDGES[name]
    q, k, v, dout = _inputs(name)
    if layout == "bhsd":
        q, k, v, dout = _head_major(q, k, v, dout)
    kw = dict(causal=causal, layout=layout, kv_valid=kv_valid)
    t = [torch.from_numpy(x) for x in (q, k, v, dout)]
    out, lse = plain_flash_attention(*t[:3], return_lse=True, **kw)
    got = plain_flash_attention_bwd(*t[:3], out, lse, t[3], **kw)
    for g, w in zip(got, jax_grads[name, layout]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    if kv_valid is not None:  # nothing flows back into the masked keys
        seq = 2 if layout == "bhsd" else 1
        for g in got[1:]:
            assert not g.narrow(seq, kv_valid, skv - kv_valid).any()


@pytest.mark.parametrize("name", SELF_EDGES)
def test_plain_attention_qkv_bwd_matches_jax_at_tile_borders(jax_grads, name):
    _, _, s, hq, hkv, _, causal, kv_valid = EDGES[name]
    q, k, v, dout = _inputs(name)
    qkv = torch.from_numpy(np.concatenate(_head_major(q, k, v), axis=1))
    dout = torch.from_numpy(_head_major(dout)[0])
    kw = dict(causal=causal, kv_valid=kv_valid)
    out, lse = plain_attention_qkv(qkv, hq, hkv, return_lse=True, **kw)
    got = plain_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
    want = jax_grads[name, "qkv"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if kv_valid is not None:
        assert not got[:, hq:, kv_valid:].any()
