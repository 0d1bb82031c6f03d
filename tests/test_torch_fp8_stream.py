"""The fp8 decode matvec's (K9) work plan and plain version at the
persistent split-K kernel's borders, on the CPU.

- `matvec_plan` / `matvec_partition` (the mirror of
  `csrc/decode_matvec.cuh`'s `plan` and of how each block and warp derives
  its work from it): every (16-channel tile, 8-row block, 64-byte K step)
  is streamed by exactly one warp, each warp's steps of an item are its own
  residue mod the split, the streams take contiguous runs of items in
  order, no launch needs more blocks than the card has SMs, and the split
  chosen leaves the busiest warp no more steps than the other would. At
  the probe's three shapes, at the smoke's ragged shape, at N below one
  tile, K below one step, K off 16 bytes, K = 8256 (129 steps, which
  neither split divides), M across the row blocks, int4's two values a
  byte, and on 132 SMs (H100 SXM), 114 (H100 PCIe) and 8; the plans at the
  probe's shapes are the ones `PERF.md` reports.
- `fp8_form`: the stream body only where the rows of x and of the weight
  start on 16 bytes and the plan gives a stream more than one item or an
  item 16 warps; the tile body elsewhere (wqkv, the ragged shape, one tile).
- `plain_fp8_matmul` against the probe's Pallas `fp8_matmul` in interpret
  mode (`pltpu.force_tpu_interpret_mode()`, as `tests/test_torch_fp8.py`
  runs it) at M = 1..9 and K = 64, 100 and 2050, out fp32: within 1e-5
  relative (the same fp32 products, summed in another order). One module
  fixture runs every Pallas case once.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import importlib.util
import os
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aigv_assessor_torch.ops import fp8_matmul as f8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5

# (M, K, N, kpb)
PLAN_CASES = [
    (8, 2048, 4096, 1), (8, 2048, 16384, 1), (8, 8192, 2048, 1),  # the probe's
    (1, 2048, 4096, 1), (4, 8192, 2048, 1),
    (3, 2050, 4100, 1),  # chip_smoke.FP8_RAGGED
    (8, 2048, 15, 1), (1, 2048, 1, 1),  # N below one tile
    (8, 63, 4096, 1), (2, 1, 40, 1),  # K below one step
    (5, 100, 257, 1), (9, 2050, 300, 1),  # K off 16 bytes
    (8, 8256, 2048, 1), (17, 8256, 2064, 1),  # 129 steps
    (64, 2048, 4096, 2), (4, 8192, 2048, 2), (16, 2047, 1000, 2),  # int4's 2 a byte
]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_partition_covers_every_step_once(case, sms):
    m, k, n, kpb = case
    plan = f8.matvec_plan(m, n, k, kpb, sms)
    tiles, rblocks = -(-n // f8.CH), -(-m // f8.ROWS)
    items = tiles * rblocks
    steps = -(-(-(-k // kpb)) // f8.KSTEP)
    assert plan.split in (8, 16) and 1 <= plan.blocks <= sms
    assert plan.streams == min(items, sms * 16 // plan.split)
    assert plan.per * plan.streams + plan.extra == items and plan.extra < plan.streams
    work = f8.matvec_partition(m, n, k, kpb, sms)
    assert len(work) == plan.streams * plan.split
    seen = Counter(unit for units in work.values() for unit in units)
    want = {(t, r, s) for t in range(tiles) for r in range(rblocks) for s in range(steps)}
    assert set(seen) == want and max(seen.values()) == 1
    for (block, warp), units in work.items():
        assert all(s % plan.split == warp % plan.split for _, _, s in units)
    # the streams take contiguous runs of items, in order, every warp of a
    # stream the same ones
    runs = {}
    for (block, warp), units in work.items():
        stream = block * (16 // plan.split) + warp // plan.split
        run = sorted({t * rblocks + r for t, r, _ in units})
        assert runs.setdefault(stream, run) == run or not units
    flat = [i for stream in sorted(runs) for i in runs[stream]]
    assert flat == list(range(items))
    # the busiest warp streams no more steps than under the other split
    other = 24 - plan.split
    streams_other = min(items, sms * 16 // other)
    busiest = -(-items // plan.streams) * -(-steps // plan.split)
    assert busiest <= -(-items // streams_other) * -(-steps // other)


def test_plan_at_the_probe_shapes():
    assert f8.matvec_plan(8, 4096, 2048) == (8, 256, 1, 0, 128)  # wqkv: one item a stream
    assert f8.matvec_plan(8, 16384, 2048) == (8, 264, 3, 232, 132)  # w13: 3-4 items
    assert f8.matvec_plan(8, 2048, 8192) == (16, 128, 1, 0, 128)  # w2: K split in 16
    assert f8.matvec_plan(3, 4100, 2050) == (8, 257, 1, 0, 129)
    assert f8.matvec_plan(8, 16, 64) == (8, 1, 1, 0, 1)


def _operands(m, k, n, x_offset=0):
    x = torch.zeros((m, k + 8), dtype=torch.bfloat16)[:, x_offset:x_offset + k]
    w8 = torch.zeros((n, k), dtype=torch.uint8).view(torch.float8_e4m3fn)
    return x, w8


@pytest.mark.parametrize("case,form", [
    ((8, 2048, 4096, 0), "tiles"),  # wqkv: every stream one item on 8 warps
    ((8, 2048, 16384, 0), "stream"),  # w13: 3-4 items a stream
    ((8, 8192, 2048, 0), "stream"),  # w2: 16 warps an item
    ((1, 2048, 4096, 0), "tiles"),
    ((64, 2048, 4096, 0), "stream"),  # 8 row blocks: several items a stream
    ((3, 2050, 4100, 0), "tiles"),  # rows off 16 bytes
    ((8, 8192, 2048, 1), "tiles"),  # x's base off 16 bytes
    ((8, 64, 16, 0), "tiles"),  # one item
], ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else c)
def test_form_follows_the_rows_and_the_plan(case, form):
    m, k, n, x_offset = case
    x, w8 = _operands(m, k, n, x_offset)
    assert f8.fp8_form(m, k, n, x, w8, f8.H100_SMS) == form


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "fp8_decode_probe", os.path.join(REPO, "benchmarks", "fp8_decode_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASE_ROWS = tuple(range(1, 10))
CASE_KS = (64, 100, 2050)
CASE_N = 40


def case_inputs(m: int, k: int):
    """bf16 values of x (held in fp32, as XLA:CPU has no bf16 dot) and the
    float weight [N, K], with an all-zero channel and a channel of tiny
    values (e4m3 subnormals after scaling)."""
    rng = np.random.default_rng(1000 * m + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    x = x.to(torch.bfloat16).float().numpy()
    w = (rng.normal(size=(CASE_N, k)) * 0.02).astype(np.float32)
    w[0] = 0.0
    w[1, : k // 2] *= 1e-4
    return x, w


@pytest.fixture(scope="module")
def probe_outputs(probe):
    """The probe's Pallas kernel in interpret mode at every (M, K), fp32 out."""
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for k in CASE_KS:
            for m in CASE_ROWS:
                x, w = case_inputs(m, k)
                w8, scale = f8.quantize_weight_fp8(torch.from_numpy(w))
                w_fp8 = jnp.asarray(np.ascontiguousarray(w8.view(torch.uint8).numpy().T))
                out[m, k] = np.asarray(probe.fp8_matmul(
                    jnp.asarray(x), w_fp8.view(jnp.float8_e4m3fn), jnp.asarray(scale.numpy()),
                    out_dtype=jnp.float32))
    return out


@pytest.mark.parametrize("k", CASE_KS)
@pytest.mark.parametrize("m", CASE_ROWS)
def test_plain_version_matches_the_probe_at_the_borders(probe_outputs, m, k):
    x, w = case_inputs(m, k)
    w8, scale = f8.quantize_weight_fp8(torch.from_numpy(w))
    got = f8.plain_fp8_matmul(torch.from_numpy(x).to(torch.bfloat16), w8, scale,
                              out_dtype=torch.float32).numpy()
    want = probe_outputs[m, k]
    assert got.shape == want.shape == (m, CASE_N)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    assert not got[:, 0].any() and not want[:, 0].any()
