"""The port's CUDA kernels against their plain versions, on the card.

jax-free, so that it runs where jax is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

- The flash-attention kernel (K1). Both sides get the same bf16 inputs; the
  plain version computes in fp32 from them, the kernel accumulates in fp32
  and rounds P to bf16 before the PV product, as the Pallas kernel does.
  Tolerance atol = rtol = 2e-2, about four bf16 ulps at the outputs' scale.
  Its dense `bsd` output equals its `bhsd` output transposed, bit for bit:
  only the store addresses differ.
- The forward with logsumexp (K1 lse) and the backward kernel (K3a / K3b, one
  kernel a key tile). `out` is bit-equal to the forward without logsumexp; the logsumexp
  is within 1e-4 of the plain fp32 one; dq, dk and dv are each within 2e-3
  relative L2 of `plain_attention_qkv_bwd`, which rounds p and ds to bf16
  where the kernels do (the JAX kernels keep them fp32), so what is left is
  the summation order and the bf16 rounding of the results. Also at the
  backward kernel's tile borders and internlm2-chat-20b's shape; delta as
  its first launch writes it within 1e-5 relative L2 of the fp32 expression;
  a second run bit-equal to the first (dQ summed over the key tiles in a
  fixed order); captured in a CUDA graph and replayed three times bit-equal,
  and two backwards at once on two streams each bit-equal to its run alone.
  `FlashAttentionQKV` is run end to end through `torch.autograd.grad`.
- The fused quantize kernels (K4a-c, K5a, K5b) at the 2B path's shapes, at
  the 8B decoder's 14336-wide SwiGLU feed, at a ragged row count and at
  small widths. The kernel sums a row in another order than the plain
  version, and tanh, exp and rsqrt come from other library code, so y / s can
  land on the other side of a half: the scales agree to rtol 1e-5, and at
  most 1e-3 of the int8 values differ, each by one. On `tie_grid`'s rows,
  where every producer computes y exactly and y / s is a half-integer or an
  integer, q and s equal rint(y / s) and s bit for bit: the quotient's
  shortcut takes the division on every tie.
- The int8 product's checks on the card.
- The three-tensor forward (K2): against `plain_flash_attention` at the same
  2e-2, in both layouts, on views of one projection output, with GQA, causal,
  `kv_valid` and Sq != Skv; and bit-equal to K1 on the same data, whose
  kernel body it shares.
- The forward's tile borders (one row, 127 / 129 / 257 rows, kv_valid 1 and
  inside a tile, causal at a ragged S, G = 6, 25 heads at D = 128, Sq > Skv
  and Sq < Skv), through both entries, both layouts and all three forms:
  against the plain versions at the same 2e-2 and 1e-4, with the bit-for-bit
  equalities above; and views that a TMA tensor map cannot describe (a row
  stride off 16 bytes, a base off 16 bytes) raise before any launch.
- K2's training forms: the forward with logsumexp (out bit-equal to the
  forward without, lse within 1e-4) and the backward kernel on three
  tensors (each within 2e-3 relative L2 of `plain_flash_attention_bwd`, dk /
  dv of masked keys exactly 0, delta within 1e-5, a second run bit-equal),
  at the small shapes and the forward's tile borders in both layouts and at
  InternViT-6B's (32 frames, 25 heads, 1032 rows, kv_valid 1025, D = 128,
  q / k contiguous and v a strided view of the projection);
  `FlashAttention` end to end through `torch.autograd.grad`.
- The weight-only matmuls (K6 int8, K7 int4): relative L2 at most 2e-3 from
  the plain version, which multiplies the same bf16 inputs in fp32 (what is
  left is the summation order and one bf16 rounding of the result), at ragged
  M, N and K and across the borders of the GEMM, GEMV and unaligned forms,
  with and without a bias; an all-zero weight column with scale 1 gives
  exactly 0. Each form reached by name (`_launch_form`) at a shape all three
  take; the wrappers' per-form launch counts; the GEMM form refusing rows
  that TMA cannot describe.
- The decode-attention kernel (K8): `out` within bf16 rounding of the plain
  version (atol = rtol = 2e-2; the kernel keeps p in fp32 where the plain
  version rounds it to bf16, below the rounding of `out`), `m` and `l` within
  1e-4 relative; ragged windows, empty and one-row windows, rows outside the
  window holding NaN (never loaded), the cache read through its strides as a
  layer of a stacked cache, every group size; merged with the current token
  against `two_part_cached_attention`. The fused entry (one launch, the
  current token merged in fp32) within the same 2e-2 of
  `plain_cached_decode_attention` at every shape with NaN outside the
  windows; captured in a CUDA graph and replayed three times, bit-equal to
  the eager call (the launch keeps no state between calls), also in the wide
  form (Phi-3-mini's step, the 2B step at B = 16) and for the window alone.
  The wide form's edges: G = 1 at D = 96 with ragged, one-row and empty
  windows, 132 and 160 (kv head, sample) pairs.
- The fp8 decode matmul (K9): relative L2 at most 1e-3 from the plain
  version rounded to bf16 (both sum exact products in fp32; what is left is
  the summation order), at the probe's shapes and decode rows, over two row
  blocks, and at K and N off every span; the quantized weight holds no NaN
  byte; an all-zero channel gives exactly 0. Both forms (`stream`, `tiles`)
  by name at every split border (the library's plan equal to
  `matvec_plan`'s, splits of 8 and 16 warps, both forms picked by the
  wrapper and counted), a second launch bit-equal, a CUDA graph replay
  bit-equal on a weight that holds every finite e4m3 code, and the convert
  bit for bit (x the identity's rows, scale 1); the stream form refuses
  rows off 16 bytes.
- The two cached paths of the decoder on the card at a small width: a
  prefill and decode steps in bf16, W8A8 (unfused, and with the fused
  decoder feeds, which launch K5a and K5b in every pass) and int8 against the
  same model on the plain decode attention, and shared-prefix scores against
  the unshared path.
- Head dim 96 (Phi-3-mini, InternVL2-4B's decoder), which the forward and
  the backward kernels run on their own D = 96 instantiations in the
  64-byte-swizzled layout of 32-column boxes: the forward at the borders of
  its 192-row q tiles and 96-key tiles (one row, 65, 191 and 193 rows
  causal, groups of 2 and 4 over a kv_valid tail of 129 in 136 rows, one
  valid key, 40 rows (fewer key tiles than ring stages), a ragged tail, and
  three tensors with 193 q rows over a kv_valid of 97), in every output form
  and with its logsumexp; the backward at its own borders (192-row q tiles
  and 64-key K/V tiles in dq, 128-key tiles over 64-row q tiles in dk/dv;
  causal with groups of 2 and 4, and three tensors across, Sq 127 over Skv
  257); and Qwen2-0.5B's 14 / 2 heads (InternVL2-1B): K1, K2, the backward
  and K8 at those shapes within the tolerances above.
- The causal forward's schedule (one persistent block an SM, q tiles aligned
  to the end of the sequence): K1 at 14 / 2 heads of 64 at one row, 193 rows
  and 2113 rows (B = 1) in every form within the tolerances above; captured
  in a CUDA graph with and without the logsumexp, replayed three times
  bit-equal to the eager launches, at Qwen2-0.5B's and the 2B decoder's
  shapes.
"""

import pytest
import torch

from aigv_assessor_torch.ops import decode_attention as dec
from aigv_assessor_torch.ops import int8_matmul as wo
from aigv_assessor_torch.ops import quant_fuse as qf
from aigv_assessor_torch.ops import w8a8
from aigv_assessor_torch.ops.attention import (
    fused_qkv_attention,
    multi_head_attention,
    two_part_cached_attention,
)
from aigv_assessor_torch.tools.quant_fuse_ab import PRODUCERS, tie_grid
from aigv_assessor_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_kernel,
    flash_attention_lse,
    flash_attention_qkv,
    flash_attention_qkv_bwd,
    flash_attention_qkv_bwd_kernel,
    flash_attention_qkv_lse,
    plain_attention_qkv,
    plain_attention_qkv_bwd,
    plain_flash_attention,
    plain_flash_attention_bwd,
)

pytestmark = pytest.mark.gpu

TOL = 2e-2
LSE_TOL = 1e-4
BWD_TOL = 2e-3
SCALE_RTOL = 1e-5
FLIP_FRACTION = 1e-3

# (B, hq, hkv, S, D, causal, kv_valid): the two forms the scoring path runs at
# 2B scale, and a small ragged shape whose keys past kv_valid hold +-1e3
SHAPES = {
    "vit": (32, 16, 16, 1032, 64, False, 1025),
    "llm": (4, 16, 8, 2113, 128, True, None),
    "ragged": (2, 4, 4, 200, 64, False, 150),
    # Phi-3-mini's decoder (InternVL2-4B), D = 96, and a ragged D = 96 shape;
    # Qwen2-0.5B's (InternVL2-1B), 14 / 2 heads of 64
    "phi3_d96": (4, 32, 32, 2113, 96, True, None),
    "ragged_d96": (2, 4, 4, 200, 96, False, 150),
    "qwen2_g7": (4, 14, 2, 2113, 64, True, None),
    # the borders of D = 96's 192-row q tiles, 64-row warpgroups and 96-key
    # tiles: one row, 65, 191 and 193 rows causal, groups of 2 and 4 over a
    # kv_valid one past a key tile, one valid key, fewer key tiles than ring
    # stages
    "s1_causal_d96": (1, 2, 2, 1, 96, True, None),
    "s65_causal_d96": (2, 4, 2, 65, 96, True, None),
    "s191_causal_d96": (1, 8, 2, 191, 96, True, None),
    "s193_causal_d96": (1, 4, 4, 193, 96, True, None),
    "gqa2_tail_d96": (1, 4, 2, 136, 96, False, 129),
    "gqa4_tail_d96": (1, 8, 2, 136, 96, False, 129),
    "kv1_d96": (1, 2, 2, 300, 96, False, 1),
    "s40_causal_d96": (1, 4, 4, 40, 96, True, None),
    # the causal kernel's q tiles, aligned to the end of the sequence, at
    # Qwen2-0.5B's 14 / 2 heads: one row (the ragged tile alone), one row
    # past a 192-row tile (a ragged tile of one row first), and 2113 rows at
    # B = 1 (168 items over the SMs)
    "s1_causal_g7": (1, 14, 2, 1, 64, True, None),
    "s193_causal_g7": (1, 14, 2, 193, 64, True, None),
    "s2113_causal_g7": (1, 14, 2, 2113, 64, True, None),
}
# shapes for the backward: both head dims, GQA with groups of 2, 4 and 6,
# causal and not, a garbage tail, and the borders of the kernel's tiles (key
# tiles of 128, 64 per warpgroup, over q tiles of 64 rows; earlier kernels'
# q tiles of 128 and 192 rows and K/V tiles of 64 keys): one row, rows one
# short of and one past a tile, kv_valid = 1, one past a tile and 1025 of
# 1032 (one valid key in the last tile); internlm2-chat-20b's attention
# (InternVL2-26B's decoder, 2 videos); Qwen2-0.5B's 14 / 2 heads causal
BWD_SHAPES = {
    "ragged": SHAPES["ragged"],
    "gqa2_causal_d128": (2, 4, 2, 200, 128, True, None),
    "gqa4_causal_d64": (1, 8, 2, 131, 64, True, None),
    "gqa2_tail_d128": (1, 4, 2, 136, 128, False, 129),
    "s1_causal_d128": (2, 16, 8, 1, 128, True, None),
    "s63_d64": (2, 4, 4, 63, 64, False, None),
    "s65_causal_d128": (2, 4, 2, 65, 128, True, None),
    "s191_causal_d64": (1, 8, 2, 191, 64, True, None),
    "s193_kv129_d64": (2, 4, 4, 193, 64, False, 129),
    "s257_causal_g6": (1, 12, 2, 257, 128, True, None),
    "kv1_d64": (2, 4, 4, 257, 64, False, 1),
    "s300_kv65_d128": (2, 5, 5, 300, 128, False, 65),
    "llm_20b": (2, 48, 8, 2113, 128, True, None),
    "phi3_d96": (2, 32, 32, 2113, 96, True, None),
    "gqa2_tail_d96": (1, 4, 2, 136, 96, False, 129),
    "s65_causal_d96": (2, 4, 2, 65, 96, True, None),
    "s191_causal_d96": (1, 8, 2, 191, 96, True, None),
    "qwen2_g7": (2, 14, 2, 2113, 64, True, None),
    "s257_d128": (1, 2, 2, 257, 128, False, None),
    "kv1025_d64": (2, 4, 4, 1032, 64, False, 1025),
    "kv1025_d128": (2, 4, 4, 1032, 128, False, 1025),
    "s193_causal_g7": (1, 14, 2, 193, 64, True, None),
}
DELTA_TOL = 1e-5  # delta from the backward's first launch against the fp32 expression, rel L2
ZERO_GRAD_ATOL = 1e-3  # dq and dk where every row has one valid key: 0 in exact arithmetic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_qkv(shape, device, seed=0):
    b, hq, hkv, s, d, _, kv_valid = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, hq + 2 * hkv, s, d), generator=gen, device=device)
    if kv_valid is not None:  # a garbage tail: +-1e3 in k and v
        qkv[:, hq : hq + hkv, kv_valid:] = 1e3
        qkv[:, hq + hkv :, kv_valid:] = -1e3
    return qkv.to(torch.bfloat16)


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain(cuda, name):
    shape = SHAPES[name]
    _, hq, hkv, s, _, causal, kv_valid = shape
    qkv = make_qkv(shape, cuda)
    before = flash_attention_qkv.launches
    got = flash_attention_qkv(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert flash_attention_qkv.launches == before + 1
    want = plain_attention_qkv(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


def test_kernel_reads_a_strided_view(cuda):
    """The ViT's head-major view of its projection output, with no copy."""
    b, n, h, d = 2, 200, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(1)
    proj = torch.randn((b, n, 3 * h * d), generator=gen, device=cuda).to(torch.bfloat16)
    view = proj.view(b, n, 3 * h, d).transpose(1, 2)
    got = flash_attention_qkv(view, h, h, kv_valid=150)
    want = flash_attention_qkv(view.contiguous(), h, h, kv_valid=150)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    qkv = make_qkv(SHAPES["ragged"], cuda)
    with pytest.raises(TypeError):
        flash_attention_qkv(qkv.float(), 4, 4)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_qkv(qkv[..., :32].contiguous(), 4, 4)
    with pytest.raises(ValueError, match="kv_valid"):
        flash_attention_qkv(qkv, 4, 4, kv_valid=0)
    with pytest.raises(ValueError, match="qkv"):
        flash_attention_qkv(qkv, 4, 2)
    with pytest.raises(ValueError, match="out_layout"):
        flash_attention_qkv(qkv, 4, 4, out_layout="bshd")


@pytest.mark.parametrize("name", list(SHAPES))
def test_bsd_output_is_bhsd_transposed(cuda, name):
    shape = SHAPES[name]
    b, hq, hkv, s, d, causal, kv_valid = shape
    qkv = make_qkv(shape, cuda, seed=2)
    kw = dict(causal=causal, kv_valid=kv_valid)
    before = flash_attention_qkv.launches
    dense = flash_attention_qkv(qkv, hq, hkv, out_layout="bsd", **kw)
    torch.cuda.synchronize()
    assert flash_attention_qkv.launches == before + 1
    assert dense.shape == (b, s, hq * d) and dense.is_contiguous()
    bhsd = flash_attention_qkv(qkv, hq, hkv, **kw)
    torch.testing.assert_close(dense, bhsd.transpose(1, 2).reshape(b, s, hq * d),
                               atol=0, rtol=0)
    want = plain_attention_qkv(qkv, hq, hkv, out_layout="bsd", **kw)
    torch.testing.assert_close(dense.float(), want.float(), atol=TOL, rtol=TOL)


def make_dout(shape, device, seed=5):
    b, hq, _, s, d, _, _ = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, hq, s, d), generator=gen, device=device).to(torch.bfloat16)


def relative_l2(x, y):
    return ((x.float() - y.float()).norm() / y.float().norm()).item()


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_with_lse_matches_plain(cuda, name):
    shape = SHAPES[name]
    _, hq, hkv, _, _, causal, kv_valid = shape
    qkv = make_qkv(shape, cuda, seed=3)
    kw = dict(causal=causal, kv_valid=kv_valid)
    before = flash_attention_qkv_lse.launches, flash_attention_qkv.launches
    out, lse = flash_attention_qkv_lse(qkv, hq, hkv, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_qkv_lse.launches, flash_attention_qkv.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(out, flash_attention_qkv(qkv, hq, hkv, **kw))
    _, want = plain_attention_qkv(qkv, hq, hkv, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == want.shape and lse.is_contiguous()
    torch.testing.assert_close(lse, want, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("name", ["qwen2_g7", "llm"])
def test_causal_forward_replays_in_a_graph(cuda, name):
    """The causal kernel (one persistent block an SM, its items dealt
    statically, no counter) captured in a CUDA graph with and without the
    logsumexp and replayed three times: bit-equal to the eager launches
    every time, at Qwen2-0.5B's and the 2B decoder's shapes."""
    shape = SHAPES[name]
    _, hq, hkv, _, _, causal, _ = shape
    qkv = make_qkv(shape, cuda, seed=4)
    want = flash_attention_qkv(qkv, hq, hkv, causal=causal)
    want_out, want_lse = flash_attention_qkv_lse(qkv, hq, hkv, causal=causal)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_attention_qkv(qkv, hq, hkv, causal=causal)
        got_out, got_lse = flash_attention_qkv_lse(qkv, hq, hkv, causal=causal)
    for _ in range(3):
        for t in (got, got_out, got_lse):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_out, want_out)
        assert torch.equal(got_lse, want_lse)
    assert torch.equal(want, want_out)


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_backward_kernels_match_plain(cuda, name):
    shape = BWD_SHAPES[name]
    _, hq, hkv, _, _, causal, kv_valid = shape
    qkv, dout = make_qkv(shape, cuda, seed=4), make_dout(shape, cuda)
    kw = dict(causal=causal, kv_valid=kv_valid)
    out, lse = flash_attention_qkv_lse(qkv, hq, hkv, **kw)
    before = flash_attention_qkv_bwd_kernel.launches
    got = flash_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
    torch.cuda.synchronize()
    assert flash_attention_qkv_bwd_kernel.launches == before + 1
    want = plain_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    if min(shape[3], kv_valid or shape[3]) == 1:
        # one valid key per row: p = 1 and ds = 0, so dq and dk are rounding
        # noise on both sides and are held to 0; dv by relative L2
        assert got[:, : hq + hkv].abs().max().item() <= ZERO_GRAD_ATOL
        assert relative_l2(got[:, hq + hkv :], want[:, hq + hkv :]) <= BWD_TOL
    else:
        for part in (slice(0, hq), slice(hq, hq + hkv), slice(hq + hkv, None)):
            assert relative_l2(got[:, part], want[:, part]) <= BWD_TOL
    if kv_valid is not None:  # nothing flows back into the masked keys
        assert not got[:, hq:, kv_valid:].any()
    # the entry into given buffers: delta as its first launch writes it; a
    # second run gives the same bits (dQ summed over the key tiles in a fixed
    # order)
    delta, again = torch.empty_like(lse), torch.empty_like(qkv)
    flash_attention_qkv_bwd_kernel(qkv, out, dout, lse, delta, again, hq, hkv, **kw)
    torch.cuda.synchronize()
    assert relative_l2(delta, (dout.float() * out.float()).sum(-1)) <= DELTA_TOL
    assert torch.equal(again, got)


def test_autograd_function_end_to_end(cuda):
    """`fused_qkv_attention` on a strided view that requires a gradient, as
    the LLM hands it over after RoPE: forward with lse, both backward
    kernels, and the gradient lands on the projection output."""
    b, s, hq, hkv, d = 2, 200, 4, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    proj = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen, device=cuda)
    proj = proj.to(torch.bfloat16).requires_grad_()
    dout = make_dout((b, hq, hkv, s, d, True, None), cuda)
    counters = (flash_attention_qkv_lse, flash_attention_qkv_bwd_kernel)
    before = [c.launches for c in counters]
    view = proj.view(b, s, hq + 2 * hkv, d).transpose(1, 2)
    out = fused_qkv_attention(view, hq, hkv, causal=True)
    (got,) = torch.autograd.grad(out, proj, dout)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref = proj.detach().clone().requires_grad_()
    ref_out = plain_attention_qkv(ref.view(b, s, hq + 2 * hkv, d).transpose(1, 2), hq, hkv,
                                  causal=True)
    (want,) = torch.autograd.grad(ref_out, ref, dout)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL, rtol=TOL)
    assert relative_l2(got, want) <= 1e-2  # autograd keeps p and ds in fp32


@pytest.mark.parametrize("name", ["llm", "vit"])
def test_backward_replays_in_a_graph(cuda, name):
    """The backward's three launches (delta and the counters' reset, the key
    tiles' kernel, dq's convert) captured in a CUDA graph, their workspace
    from the graph's pool, and replayed three times: bit-equal to the eager
    call every time, at the 2B decoder's and the 2B ViT's shapes."""
    shape = SHAPES[name]
    _, hq, hkv, _, _, causal, kv_valid = shape
    qkv, dout = make_qkv(shape, cuda, seed=8), make_dout(shape, cuda, seed=9)
    kw = dict(causal=causal, kv_valid=kv_valid)
    out, lse = flash_attention_qkv_lse(qkv, hq, hkv, **kw)
    want = flash_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_backward_on_two_streams(cuda):
    """Two backwards at once on two streams (the 2B decoder's shape and the
    ViT's), each with its own workspace and counters: each bit-equal to its
    run alone."""
    runs = []
    for name, seed in (("llm", 10), ("vit", 11)):
        shape = SHAPES[name]
        _, hq, hkv, _, _, causal, kv_valid = shape
        qkv, dout = make_qkv(shape, cuda, seed=seed), make_dout(shape, cuda, seed=seed)
        kw = dict(causal=causal, kv_valid=kv_valid)
        out, lse = flash_attention_qkv_lse(qkv, hq, hkv, **kw)
        alone = flash_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
        runs.append(((qkv, out, lse, dout, hq, hkv), kw, alone))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for stream, (args, kw, _) in zip(streams, runs):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got.append(flash_attention_qkv_bwd(*args, **kw))
    torch.cuda.synchronize()
    for g, (_, _, alone) in zip(got, runs):
        assert torch.equal(g, alone)


def test_training_wrappers_raise_rather_than_fall_back(cuda):
    shape = BWD_SHAPES["ragged"]
    qkv, dout = make_qkv(shape, cuda), make_dout(shape, cuda)
    out, lse = flash_attention_qkv_lse(qkv, 4, 4, kv_valid=150)
    delta = (dout.float() * out.float()).sum(-1)
    dqkv = torch.empty_like(qkv)
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_qkv_lse(qkv.float(), 4, 4)
    with pytest.raises(TypeError, match="bf16"):  # an fp32 tensor that needs a gradient
        flash_attention_qkv(qkv.float().requires_grad_(), 4, 4)
    with pytest.raises(ValueError, match="forward-only"):
        flash_attention_qkv(qkv.clone().requires_grad_(), 4, 4, out_layout="bsd")
    # the entry takes out before dout
    def kernel(qkv_, *rest, **kw):
        return flash_attention_qkv_bwd_kernel(qkv_, out, *rest, **kw)

    with pytest.raises(ValueError, match="dout"):
        kernel(qkv, dout.float(), lse, delta, dqkv, 4, 4, kv_valid=150)
    with pytest.raises(ValueError, match="lse"):
        kernel(qkv, dout, lse.double(), delta, dqkv, 4, 4, kv_valid=150)
    with pytest.raises(ValueError, match="contiguous head dim"):
        kernel(qkv, dout.transpose(2, 3).contiguous().transpose(2, 3), lse, delta, dqkv,
               4, 4, kv_valid=150)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(qkv, dout, lse.transpose(1, 2).contiguous().transpose(1, 2), delta, dqkv,
               4, 4, kv_valid=150)
    with pytest.raises(ValueError, match="delta"):
        kernel(qkv, dout, lse, delta[:, :2], dqkv, 4, 4, kv_valid=150)
    with pytest.raises(ValueError, match="out"):  # the entry reads out
        flash_attention_qkv_bwd_kernel(qkv, out.float(), dout, lse, delta, dqkv, 4, 4,
                                       kv_valid=150)


# (rows, cols) of each feed on the 2B path: the ViT's (32 frames x 1032
# tokens) and the decoder's (4 videos x 2113 tokens; the SwiGLU feed also at
# the 8B decoder's 14336), and a ragged row count
FEEDS = {
    "ln_quant": (33024, 1024),
    "gelu_quant": (33024, 4096),
    "ident_quant": (33024, 1024),
    "rms_quant": (8452, 2048),
    "silu_mul_quant": (8452, 8192),
    "silu_mul_quant_8b": (8452, 14336),
}
RAGGED_ROWS = 1000


def feed_calls(name):
    """(kernel wrapper, plain version, maker of the arguments after x) of one
    feed."""
    def norm(x, gen, bias=True):
        c = x.shape[-1]
        w = (1.0 + 0.2 * torch.randn(c, generator=gen, device=x.device)).to(torch.bfloat16)
        b = (0.1 * torch.randn(c, generator=gen, device=x.device)).to(torch.bfloat16)
        return (w, b) if bias else (w,)

    if name == "ln_quant":
        return qf.layernorm_quant, qf.plain_layernorm_quant, norm
    if name == "rms_quant":
        return qf.rmsnorm_quant, qf.plain_rmsnorm_quant, lambda x, gen: norm(x, gen, False)
    if name.startswith("silu_mul_quant"):
        def h3(x, gen):
            return ((2.0 * torch.randn(x.shape, generator=gen, device=x.device))
                    .to(torch.bfloat16),)
        return qf.silu_mul_quant, qf.plain_silu_mul_quant, h3
    if name == "gelu_quant":
        return qf.gelu_quant, qf.plain_gelu_quant, lambda x, gen: ()
    return qf.quant_rows, qf.plain_quant_rows, lambda x, gen: ()


def assert_quantized_close(got, want):
    (q, s), (q2, s2) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == q2.shape and s.shape == s2.shape
    torch.testing.assert_close(s, s2, rtol=SCALE_RTOL, atol=0)
    diff = (q.int() - q2.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= FLIP_FRACTION


@pytest.mark.parametrize("ragged", [False, True], ids=["path", "ragged"])
@pytest.mark.parametrize("name", list(FEEDS))
def test_feed_kernel_matches_plain(cuda, name, ragged):
    rows, cols = FEEDS[name]
    rows = RAGGED_ROWS if ragged else rows
    kernel, plain, extra = feed_calls(name)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (2.0 * torch.randn((rows, cols), generator=gen, device=cuda)).to(torch.bfloat16)
    args = extra(x, gen)
    before = kernel.launches
    got = kernel(x, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert_quantized_close(got, plain(x, *args))


@pytest.mark.parametrize("producer", PRODUCERS)
def test_feed_kernels_are_exact_on_a_tie_grid(cuda, producer):
    x, extra, eps, q_want, s_want = tie_grid(producer, cuda)
    wrapper = {"identity": qf.quant_rows, "layernorm": qf.layernorm_quant,
               "gelu": qf.gelu_quant, "rmsnorm": qf.rmsnorm_quant,
               "silu_mul": qf.silu_mul_quant}[producer]
    args = (x, *extra, eps) if producer in ("layernorm", "rmsnorm") else (x, *extra)
    q, s = wrapper(*args)
    torch.cuda.synchronize()
    assert torch.equal(s, s_want)
    assert torch.equal(q, q_want), int((q != q_want).sum())


@pytest.mark.parametrize("cols", [64, 1000, 2048])
def test_decoder_feed_kernels_at_small_widths(cuda, cols):
    """K5a / K5b on a few rows of the tiny and small widths, leading dims kept."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 7, cols), generator=gen, device=cuda).to(torch.bfloat16)
    h3 = torch.randn((2, 7, cols), generator=gen, device=cuda).to(torch.bfloat16)
    w = (1.0 + 0.2 * torch.randn(cols, generator=gen, device=cuda)).to(torch.bfloat16)
    q, s = qf.rmsnorm_quant(x, w, 1e-5)
    assert q.shape == x.shape and s.shape == (2, 7, 1)
    assert_quantized_close((q, s), qf.plain_rmsnorm_quant(x, w, 1e-5))
    assert_quantized_close(qf.silu_mul_quant(x, h3), qf.plain_silu_mul_quant(x, h3))


def test_decoder_feed_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn((64, 2048), device=cuda)
    xb = x.to(torch.bfloat16)
    w = torch.ones(2048, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        qf.rmsnorm_quant(x, w)
    with pytest.raises(TypeError, match="bf16"):
        qf.silu_mul_quant(x, xb)
    with pytest.raises(ValueError, match="second input"):
        qf.silu_mul_quant(xb, x)  # an fp32 second input
    with pytest.raises(ValueError, match="second input"):
        qf.silu_mul_quant(xb, xb[:32])
    with pytest.raises(ValueError, match="norm weight"):
        qf.rmsnorm_quant(xb, w.float())
    with pytest.raises(ValueError, match="at most 16384"):
        qf.silu_mul_quant(*(torch.zeros((4, 16392), device=cuda, dtype=torch.bfloat16),) * 2)


def test_feed_kernels_keep_leading_dims(cuda):
    x = torch.randn((4, 250, 1024), device=cuda).to(torch.bfloat16)
    q, s = qf.quant_rows(x)
    assert q.shape == x.shape and s.shape == (4, 250, 1)
    assert_quantized_close((q, s), qf.plain_quant_rows(x))


def test_feed_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn((64, 1024), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        qf.quant_rows(x)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        qf.gelu_quant(xb[:, :1020].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        qf.quant_rows(xb[:, ::2])
    w = torch.ones(512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="norm weight"):
        qf.layernorm_quant(xb, w, w)


def test_int8_product_checks_on_the_card(cuda):
    x = torch.randn((64, 256), device=cuda)
    wq = torch.randint(-127, 128, (128, 256), device=cuda, dtype=torch.int8)
    sw = torch.rand(128, device=cuda) + 0.5
    y = w8a8.w8a8_matmul(x, wq, sw, out_dtype=torch.float32)
    want = w8a8.w8a8_matmul(x.cpu(), wq.cpu(), sw.cpu(), out_dtype=torch.float32)
    torch.testing.assert_close(y.cpu(), want, rtol=1e-5, atol=1e-5)
    # a decode step's few rows: padded up to what the library's product takes
    for m in (1, 4, 16):
        y = w8a8.w8a8_matmul(x[:m], wq, sw, out_dtype=torch.float32)
        torch.testing.assert_close(y.cpu(), want[:m], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiples of 8"):
        w8a8.w8a8_matmul(x, wq[:100], sw[:100])
    with pytest.raises(ValueError, match="weight"):
        w8a8.w8a8_matmul(x, wq.float(), sw)
    with pytest.raises(TypeError, match="int8"):
        w8a8.w8a8_matmul((x, torch.ones(64, 1, device=cuda)), wq, sw)


# ------------------------------------------------ three separate tensors (K2) --

# (B, Sq, Skv, hq, hkv, D, causal, kv_valid)
SEPARATE = {
    "gqa_causal_d128": (2, 200, 200, 4, 2, 128, True, None),
    "mha_tail_d64": (2, 200, 200, 4, 4, 64, False, 150),
    "cross_d64": (2, 257, 1025, 4, 4, 64, False, None),
    "cross_gqa_tail_d128": (1, 70, 333, 8, 2, 128, False, 300),
    "gqa_causal_d96": (2, 200, 200, 4, 2, 96, True, None),
    "cross_tail_d96": (1, 70, 333, 8, 8, 96, False, 300),
    "cross_gqa_d96": (2, 127, 257, 12, 2, 96, False, None),
    # one q row past a 192-row q tile, kv_valid one past a 96-key tile
    "s193_kv97_d96": (1, 193, 193, 8, 2, 96, False, 97),
    # the backward's 128-key tiles: Skv one short of, one past and one past
    # two tiles, kv_valid 1025 of 1032 at D = 64 and 128, and Qwen2-0.5B's 14
    # / 2 heads causal at 193 and 2113 rows
    "skv127_d64": (2, 100, 127, 4, 2, 64, False, None),
    "skv129_d128": (2, 100, 129, 4, 2, 128, False, None),
    "s257_d128": (1, 257, 257, 4, 4, 128, False, None),
    "kv1025_d64": (1, 1032, 1032, 4, 4, 64, False, 1025),
    "kv1025_d128": (1, 1032, 1032, 4, 4, 128, False, 1025),
    "s193_causal_g7": (1, 193, 193, 14, 2, 64, True, None),
    "s2113_causal_g7": (1, 2113, 2113, 14, 2, 64, True, None),
}


def make_separate(case, device, layout, seed=11):
    b, sq, skv, hq, hkv, d, _, kv_valid = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=gen, device=device)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=device)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=device)
    if kv_valid is not None:
        k[:, kv_valid:], v[:, kv_valid:] = 1e3, -1e3
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if layout == "bhsd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(SEPARATE))
def test_separate_kernel_matches_plain(cuda, name, layout):
    case = SEPARATE[name]
    q, k, v = make_separate(case, cuda, layout)
    kw = dict(causal=case[6], layout=layout, kv_valid=case[7])
    before = flash_attention.launches, flash_attention_qkv.launches
    got = multi_head_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_qkv.launches) == (before[0] + 1, before[1])
    want = plain_flash_attention(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


def test_separate_kernel_reads_views_and_equals_the_fused_kernel(cuda):
    """q, k and v as the weight-only decoder hands them over: [B, S, H, D]
    slices of one row-major projection output. The same data as one
    head-major fused view through K1 gives the same bits."""
    b, s, hq, hkv, d = 2, 200, 4, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(12)
    proj = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen, device=cuda).to(torch.bfloat16)
    q = proj[..., : hq * d].view(b, s, hq, d)
    k = proj[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
    v = proj[..., (hq + hkv) * d :].view(b, s, hkv, d)
    assert not v.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    fused = flash_attention_qkv(proj.view(b, s, hq + 2 * hkv, d).transpose(1, 2), hq, hkv,
                                causal=True, out_layout="bsd")
    assert torch.equal(got.reshape(b, s, hq * d), fused)
    torch.testing.assert_close(
        got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True),
        atol=0, rtol=0)


def test_separate_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = make_separate(SEPARATE["gqa_causal_d128"], cuda, "bshd")
    with pytest.raises(TypeError, match="bf16"):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k[:, :100], v[:, :100], causal=True)
    with pytest.raises(ValueError, match="kv_valid"):
        flash_attention(q, k, v, kv_valid=201)
    with pytest.raises(ValueError, match="layout"):
        flash_attention(q, k, v, layout="sbhd")
    # a tensor that needs a gradient goes through FlashAttention's kernels
    counters = (flash_attention, flash_attention_lse, flash_attention_bwd_kernel)
    before = [c.launches for c in counters]
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v, causal=True)
    assert "FlashAttention" in type(out.grad_fn).__name__
    (grad,) = torch.autograd.grad(out, qg, torch.ones_like(out))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 1, 1]
    assert grad.shape == q.shape and torch.isfinite(grad).all()


# (B, Sq, Skv, hq, hkv, D, causal, kv_valid) of InternViT-6B: 32 frames, 25
# heads of 128, 1025 tokens padded to 1032
VIT_6B = (32, 1032, 1032, 25, 25, 128, False, 1025)


def make_vit_6b(device, seed=14):
    """q and k as the norms give them (contiguous [B, N, H, D]) and v a
    strided view of the [B, N, 3C] projection, with a garbage tail."""
    b, n, _, h, _, d, _, kv_valid = VIT_6B
    gen = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn((b, n, 3 * h * d), generator=gen, device=device)
    proj[:, kv_valid:, h * d :] = 1e3  # garbage k and v rows
    proj = proj.to(torch.bfloat16)
    q, k, v = proj.split(h * d, dim=-1)
    return (q.reshape(b, n, h, d), k.reshape(b, n, h, d), v.view(b, n, h, d))


def check_separate_training(q, k, v, kw, seed=15):
    """The three training kernels on (q, k, v) against the plain versions."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(torch.bfloat16)
    counters = (flash_attention, flash_attention_lse, flash_attention_bwd_kernel)
    before = [c.launches for c in counters]
    out, lse = flash_attention_lse(q, k, v, **kw)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 1, 1]
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    _, want_lse = plain_flash_attention(q, k, v, return_lse=True, **kw)
    assert lse.shape == want_lse.shape and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=0)
    want = plain_flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    seq = 2 if kw["layout"] == "bhsd" else 1
    kv_valid = kw.get("kv_valid")
    one_key = min(k.shape[seq], kv_valid or k.shape[seq]) == 1
    for name, got, ref, t in zip("qkv", (dq, dk, dv), want, (q, k, v)):
        assert got.shape == t.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.isfinite(got).all()
        if one_key and name != "v":  # 0 in exact arithmetic: held to 0
            assert got.abs().max().item() <= ZERO_GRAD_ATOL
        else:
            assert relative_l2(got, ref) <= BWD_TOL
    if kv_valid is not None:  # nothing flows back into the masked keys
        assert not dk.narrow(seq, kv_valid, k.shape[seq] - kv_valid).any()
        assert not dv.narrow(seq, kv_valid, k.shape[seq] - kv_valid).any()
    # the entry into given buffers: delta from its first launch; a second run
    # gives the same bits (dQ summed over the key tiles in a fixed order)
    delta = torch.empty_like(lse)
    again = [torch.empty_like(t) for t in (dq, dk, dv)]
    flash_attention_bwd_kernel(q, k, v, out, dout, lse, delta, *again, **kw)
    torch.cuda.synchronize()
    want_delta = (dout.float() * out.float()).sum(-1)
    if kw["layout"] == "bshd":
        want_delta = want_delta.transpose(1, 2)
    assert relative_l2(delta, want_delta) <= DELTA_TOL
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(SEPARATE))
def test_separate_training_kernels_match_plain(cuda, name, layout):
    case = SEPARATE[name]
    q, k, v = make_separate(case, cuda, layout, seed=16)
    check_separate_training(q, k, v, dict(causal=case[6], layout=layout, kv_valid=case[7]))


def test_separate_training_kernels_at_the_vit_6b_shape(cuda):
    q, k, v = make_vit_6b(cuda)
    assert not v.is_contiguous()
    check_separate_training(q, k, v, dict(layout="bshd", kv_valid=VIT_6B[7]))


def test_separate_autograd_function_end_to_end(cuda):
    """`multi_head_attention` on the QK-normalized ViT's tensors, all three
    needing a gradient through one projection output: the gradient lands on
    the projection, close to autograd through the plain forward."""
    b, n, h, d, kv_valid = 2, 200, 5, 128, 193
    gen = torch.Generator(device=cuda).manual_seed(17)
    proj = torch.randn((b, n, 3 * h * d), generator=gen, device=cuda)
    proj = proj.to(torch.bfloat16).requires_grad_()
    dout = torch.randn((b, n, h, d), generator=gen, device=cuda).to(torch.bfloat16)

    def split(t):
        q, k, v = t.split(h * d, dim=-1)
        return (x.reshape(b, n, h, d) for x in (q, k, v))

    counters = (flash_attention_lse, flash_attention_bwd_kernel)
    before = [c.launches for c in counters]
    out = multi_head_attention(*split(proj), kv_valid=kv_valid)
    (got,) = torch.autograd.grad(out, proj, dout)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [c + 1 for c in before]
    ref = proj.detach().clone().requires_grad_()
    ref_out = plain_flash_attention(*split(ref), kv_valid=kv_valid)
    (want,) = torch.autograd.grad(ref_out, ref, dout)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL, rtol=TOL)
    assert relative_l2(got, want) <= 1e-2  # autograd keeps p and ds in fp32


def test_separate_training_wrappers_raise_rather_than_fall_back(cuda):
    q, k, v = make_separate(SEPARATE["mha_tail_d64"], cuda, "bshd")
    out, lse = flash_attention_lse(q, k, v, kv_valid=150)
    dout = torch.ones_like(q)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_lse(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="layout"):
        flash_attention_lse(q, k, v, layout="sbhd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    kernel = flash_attention_bwd_kernel
    with pytest.raises(ValueError, match="dout"):
        kernel(q, k, v, out, dout.float(), lse, delta, dq, dk, dv)
    with pytest.raises(ValueError, match="out"):
        kernel(q, k, v, out[:, :100], dout, lse, delta, dq, dk, dv)
    with pytest.raises(ValueError, match="lse"):
        kernel(q, k, v, out, dout, lse[:, :2], delta, dq, dk, dv)
    with pytest.raises(ValueError, match="delta"):
        kernel(q, k, v, out, dout, lse, delta.double(), dq, dk, dv)
    with pytest.raises(ValueError, match="dq"):
        kernel(q, k, v, out, dout, lse, delta, dq[:, :100], dk, dv)
    with pytest.raises(ValueError, match="strides"):  # D not contiguous
        kernel(q, k, v, out, dout, lse, delta, dq,
               dk.transpose(1, 3).contiguous().transpose(1, 3), dv)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(q, k, v, out, dout, lse.transpose(1, 2).contiguous().transpose(1, 2), delta, dq,
               dk, dv)



# --------------------------------------- the forward's tile borders (K1, K2) --

# (B, Sq, Skv, hq, hkv, D, causal, kv_valid) at the borders of the forward's
# tiles (128 q rows per block, 128 or 176 keys per K/V tile): one row, rows
# one short of and one past a tile, kv_valid = 1 and inside a tile, causal at
# a ragged S, G = 6 (internlm2-chat-20b's 48 / 8 heads), 25 heads at D = 128,
# and non-causal Sq > Skv and Sq < Skv. Keys past kv_valid hold +-1e3.
EDGES = {
    "s1_causal_gqa": (3, 1, 1, 16, 8, 128, True, None),
    "s127_kv_in_tile": (2, 127, 127, 16, 16, 64, False, 100),
    "s129_causal": (2, 129, 129, 16, 8, 128, True, None),
    "s257_causal_g6": (1, 257, 257, 48, 8, 128, True, None),
    "kv_valid_1": (2, 257, 257, 16, 16, 64, False, 1),
    "h25_d128": (2, 300, 300, 25, 25, 128, False, 257),
    "sq_gt_skv": (2, 300, 129, 16, 8, 64, False, 100),
    "sq_lt_skv_g6": (2, 127, 257, 48, 8, 128, False, None),
}
SELF_EDGES = [name for name, case in EDGES.items() if case[1] == case[2]]


def make_edge(case, device, seed=30):
    """q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D] with a garbage tail."""
    b, sq, skv, hq, hkv, d, _, kv_valid = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=gen, device=device)
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=device) for _ in range(2))
    if kv_valid is not None:
        k[:, kv_valid:], v[:, kv_valid:] = 1e3, -1e3
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(EDGES))
def test_separate_forward_at_tile_borders(cuda, name, layout, with_lse):
    """K2 against its plain version at each border, in both layouts, with
    and without the logsumexp; `out` is bit-equal with and without it."""
    case = EDGES[name]
    q, k, v = make_edge(case, cuda)
    if layout == "bhsd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=case[6], layout=layout, kv_valid=case[7])
    fn = flash_attention_lse if with_lse else flash_attention
    before = fn.launches
    res = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    out, lse = res if with_lse else (res, None)
    want, want_lse = plain_flash_attention(q, k, v, return_lse=True, **kw)
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    if with_lse:
        assert torch.equal(out, flash_attention(q, k, v, **kw))
        assert lse.shape == want_lse.shape and torch.isfinite(lse).all()
        torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", list(EDGES))
def test_separate_training_kernels_at_tile_borders(cuda, name, layout):
    """K2's forward with logsumexp and its backward at each border (Sq > Skv
    and Sq < Skv among them), in both layouts: against the plain versions,
    delta from the backward's first launch, and a second run bit-equal."""
    case = EDGES[name]
    q, k, v = make_edge(case, cuda, seed=31)
    if layout == "bhsd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    check_separate_training(q, k, v, dict(causal=case[6], layout=layout, kv_valid=case[7]))


@pytest.mark.parametrize("form", ["bhsd", "bsd", "lse"])
@pytest.mark.parametrize("name", SELF_EDGES)
def test_fused_forward_at_tile_borders(cuda, name, form):
    """K1 off one fused head-major array at each border with Sq == Skv, in
    its three forms: against the plain version; `bsd` equal to `bhsd`
    transposed and the lse form's `out` equal to the plain form's, bit for
    bit; and K2 on the array's three head ranges equal to K1, bit for bit."""
    b, s, _, hq, hkv, d, causal, kv_valid = EDGES[name]
    q, k, v = make_edge(EDGES[name], cuda)
    qkv = torch.cat([t.transpose(1, 2) for t in (q, k, v)], dim=1)  # [B, hq + 2 hkv, S, D]
    kw = dict(causal=causal, kv_valid=kv_valid)
    bhsd = flash_attention_qkv(qkv, hq, hkv, **kw)
    fn = flash_attention_qkv_lse if form == "lse" else flash_attention_qkv
    before = fn.launches
    if form == "lse":
        out, lse = flash_attention_qkv_lse(qkv, hq, hkv, **kw)
    else:
        out = flash_attention_qkv(qkv, hq, hkv, out_layout=form, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want, want_lse = plain_attention_qkv(qkv, hq, hkv, return_lse=True, **kw)
    if form == "bsd":
        assert out.shape == (b, s, hq * d)
        assert torch.equal(out, bhsd.transpose(1, 2).reshape(b, s, hq * d))
    else:
        assert torch.equal(out, bhsd)
        torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    if form == "lse":
        torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=0)
    parts = (qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :])
    assert torch.equal(flash_attention(*parts, layout="bhsd", **kw), bhsd)


def test_forward_raises_on_views_tma_cannot_describe(cuda):
    """The forward reads and writes through TMA tensor maps, which take
    strides that are multiples of 16 bytes from a 16-byte aligned base.
    Both entries refuse a view whose row stride is 4 bytes past that, or
    whose base is 2 bytes off, before any launch."""
    b, s, h, d = 2, 64, 4, 64
    row = 3 * h * d + 2  # elements: not a multiple of 8
    flat = torch.zeros(b * s * row + 16, dtype=torch.bfloat16, device=cuda)
    qkv = flat[: b * s * row].view(b, s, row)[..., : 3 * h * d].unflatten(-1, (3 * h, d))
    qkv = qkv.transpose(1, 2)  # [B, 3h, S, D], row stride 3hD + 2
    q, k, v = (qkv[:, i * h : (i + 1) * h].transpose(1, 2) for i in range(3))
    shifted = flat[1 : 1 + b * h * s * d].view(b, h, s, d)
    good = torch.zeros((b, h, s, d), dtype=torch.bfloat16, device=cuda)
    counters = (flash_attention, flash_attention_lse, flash_attention_qkv,
                flash_attention_qkv_lse)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_qkv(qkv, h, h)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_qkv_lse(qkv, h, h)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(shifted, good, good, layout="bhsd")
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_lse(good, good, shifted, layout="bhsd")
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before

# ------------------------------------------------ weight-only matmuls (K6, K7) --

WO_TOL = 2e-3
# (M, K, N): a decoder projection at a ragged M, single rows, N off the 128
# tiles and odd (rows of y lose their 4-byte alignment), K off the 32 steps,
# K odd (x loses its 16-byte rows; int4 pads a nibble); then the borders of
# the three forms (`weight_only_form`): M = 8 / 9 and 16 / 17 (the GEMV form's
# 8-row blocks), M = 64 / 65 (GEMV_MAX_ROWS: the GEMV form to the GEMM
# form), M = 127 / 128 / 129 with N = 255 / 256 / 257 (two of the GEMM's
# 128-channel tiles), M = 255 / 256 / 257 (its 256-row tiles) with N = 127 /
# 128 / 129, K = 64 (one step), K = 160 (a ragged last step), K = 100 (rows
# off 16 bytes: unaligned), and the LM head's N = 92553; then WO_GEMM_EDGES
WO_SHAPES = [(300, 2048, 512), (1, 2048, 256), (4, 1024, 1001), (70, 200, 130), (33, 2047, 96),
             (8, 2048, 1024), (9, 2048, 1024), (16, 2048, 1024), (17, 2048, 1024),
             (64, 2048, 1024), (65, 2048, 1024), (127, 2048, 255), (128, 2048, 256),
             (129, 2048, 257), (255, 1024, 127), (256, 1024, 128), (257, 1024, 129),
             (300, 64, 512), (300, 160, 512), (300, 100, 512), (4, 2048, 92553)]
# (M, K, N) where the GEMM form's schedule changes on 132 SMs (tiles of 256
# rows x 128 channels): 131, 132, 133, 143, 264, 528 tiles, the 2B wo's 544
# (33 full m tiles and one of 4 rows, whose products run 64 wide) at a short
# K, and last m tiles of 100 and 200 rows (products 128 and 256 wide)
WO_GEMM_EDGES = [(33536, 64, 128), (2816, 256, 1536), (34048, 64, 128), (2816, 256, 1537),
                 (5632, 64, 1536), (8448, 64, 2048), (4 * 2113, 256, 2048), (612, 256, 384),
                 (456, 256, 384)]
WO_SHAPES += WO_GEMM_EDGES


def make_weight_only(bits, m, k, n, device, bias, seed=13):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((n, k), generator=gen, device=device) * 0.02
    w[n // 2] = 0.0  # an all-zero output channel: scale 1, output exactly 0
    q, scale = (wo.quantize_weight if bits == 8 else wo.quantize_kernel_int4)(w)
    b = (torch.randn(n, generator=gen, device=device) * 0.1).to(torch.bfloat16) if bias else None
    return x, q, scale, b


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("shape", WO_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_weight_only_kernel_matches_plain(cuda, bits, shape, bias):
    m, k, n = shape
    kernel, plain = ((wo.int8_matmul, wo.plain_int8_matmul) if bits == 8
                     else (wo.int4_matmul, wo.plain_int4_matmul))
    x, q, scale, b = make_weight_only(bits, m, k, n, cuda, bias)
    before = kernel.launches
    got = kernel(x, q, scale, b)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(x, q, scale, b, out_dtype=torch.float32)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert relative_l2(got, want) <= WO_TOL
    if not bias:
        assert scale[n // 2] == 1.0 and not got[:, n // 2].any()


@pytest.mark.parametrize("form", ["gemm", "gemv", "unaligned"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_weight_only_each_form_matches_plain(cuda, bits, form):
    """Every form, reached by name, at a shape all three take (aligned rows,
    M above the GEMV threshold, ragged M and N, a bias), counted nowhere."""
    m, k, n = 300, 2048, 384
    plain = wo.plain_int8_matmul if bits == 8 else wo.plain_int4_matmul
    kernel = wo.int8_matmul if bits == 8 else wo.int4_matmul
    x, q, scale, b = make_weight_only(bits, m, k, n, cuda, True)
    assert wo.weight_only_form(m, k, n, bits, x, q) == "gemm"
    before = kernel.launches, dict(kernel.form_launches)
    got = wo._launch_form(form, bits, x, q, scale, b)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.form_launches) == before
    assert got.shape == (m, n) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert relative_l2(got, plain(x, q, scale, b, out_dtype=torch.float32)) <= WO_TOL


@pytest.mark.parametrize("shape", WO_GEMM_EDGES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_weight_only_gemm_form_reruns_bit_equal(cuda, bits, shape):
    """The GEMM form sums each output in a fixed order: a second launch and
    a CUDA graph replay give the first launch's bits, where the schedule
    changes as on the model's shapes."""
    m, k, n = shape
    x, q, scale, b = make_weight_only(bits, m, k, n, cuda, True)

    def gemm():
        return wo._launch_form("gemm", bits, x, q, scale, b)

    first, again = gemm(), gemm()
    static = torch.empty_like(first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static.copy_(gemm())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, static)


def test_weight_only_wrappers_count_launches_by_form(cuda):
    """Each launch counts once in `.launches` and once under the form the
    wrapper took: GEMV at or below GEMV_MAX_ROWS rows, GEMM above,
    unaligned for rows off 16 bytes."""
    for bits, kernel in ((8, wo.int8_matmul), (4, wo.int4_matmul)):
        cases = [(wo.GEMV_MAX_ROWS, 2048, 256, "gemv"), (wo.GEMV_MAX_ROWS + 1, 2048, 256, "gemm"),
                 (300, 2047, 256, "unaligned")]
        for m, k, n, form in cases:
            x, q, scale, _ = make_weight_only(bits, m, k, n, cuda, False)
            launches, forms = kernel.launches, dict(kernel.form_launches)
            kernel(x, q, scale)
            forms[form] += 1
            assert kernel.launches == launches + 1 and kernel.form_launches == forms
    torch.cuda.synchronize()


def test_weight_only_gemm_form_refuses_what_tma_cannot_describe(cuda):
    x, q, scale, _ = make_weight_only(8, 64, 2047, 256, cuda, False)
    with pytest.raises(RuntimeError, match="gemm"):
        wo._launch_form("gemm", 8, x, q, scale)
    with pytest.raises(ValueError, match="form"):
        wo._launch_form("tiled", 8, x, q, scale)


def test_weight_only_dense_apply_keeps_leading_dims(cuda):
    x, q, scale, _ = make_weight_only(8, 6 * 50, 256, 384, cuda, False)
    got = wo.int8_dense_apply(x.view(6, 50, 256), q, scale)
    assert got.shape == (6, 50, 384)
    torch.testing.assert_close(got.view(300, 384), wo.int8_matmul(x, q, scale), atol=0, rtol=0)
    p, s4 = wo.quantize_kernel_int4(wo.dequantize_kernel(q, scale))
    assert wo.int4_dense_apply(x.view(6, 50, 256), p, s4).shape == (6, 50, 384)


def test_weight_only_kernels_reject_what_they_do_not_take(cuda):
    x, q, scale, _ = make_weight_only(8, 16, 256, 128, cuda, False)
    with pytest.raises(TypeError, match="bf16"):
        wo.int8_matmul(x.float(), q, scale)
    with pytest.raises(TypeError, match="bf16"):
        wo.int8_matmul(x, q, scale, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="weight"):
        wo.int8_matmul(x, q.float(), scale)
    with pytest.raises(ValueError, match="weight"):
        wo.int4_matmul(x, q, scale)  # 256 bytes per row where int4 has 128
    with pytest.raises(ValueError, match="scale"):
        wo.int8_matmul(x, q, scale.double())
    with pytest.raises(ValueError, match="contiguous"):
        wo.int8_matmul(x, q.t().contiguous().t(), scale)
    with pytest.raises(TypeError, match="bias"):
        wo.int8_matmul(x, q, scale, torch.zeros(128, device=cuda))


# ---------------------------------------------------- decode attention (K8) --

ML_RTOL = 1e-4  # m and l: fp32 on both sides, __expf against exp, another order
# (B, hq, hkv, D, max_len, end, starts)
DECODE = {
    "path_2b": (4, 16, 8, 128, 2177, 2113, (0, 0, 0, 0)),
    "ragged": (4, 16, 8, 128, 2177, 2150, (0, 700, 2100, 2149)),
    "empty_and_one_row": (3, 16, 8, 128, 300, 200, (200, 199, 150)),
    "end_zero": (2, 8, 8, 64, 128, 0, (0, 0)),
    "mha_d64": (2, 8, 8, 64, 333, 301, (0, 37)),
    "group8_d64": (2, 16, 2, 64, 500, 499, (3, 0)),
    "group4_d128": (1, 8, 2, 128, 70, 70, (0,)),
    "group3_d64": (2, 9, 3, 64, 200, 150, (0, 20)),
    "batch1_many_splits": (1, 16, 8, 128, 4096, 4000, (5,)),
    # Phi-3-mini (32 / 32 heads of 96) and Qwen2-0.5B (14 / 2 heads of 64)
    "phi3_d96": (4, 32, 32, 96, 2145, 2129, (0, 0, 0, 0)),
    "ragged_d96": (3, 8, 2, 96, 300, 250, (0, 100, 249)),
    "qwen2_g7": (4, 14, 2, 64, 2145, 2129, (0, 3, 0, 40)),
    # the wide form's edges (one piece, at most one (kv head, sample) pair an
    # SM on an H100): G = 1 at D = 96 with a ragged, a one-row and an empty
    # window; the 2B step at B = 16; 132 pairs of one tile; and 160 pairs,
    # more than the SMs, in the split form
    "phi3_ragged": (4, 32, 32, 96, 2177, 2150, (0, 701, 2149, 2150)),
    "path_2b_b16": (16, 16, 8, 128, 2177, 2113, (0,) * 16),
    "pairs_132_d64": (33, 8, 4, 64, 100, 90, (0, 5, 89, 90) * 8 + (17,)),
    "phi3_b5_pairs_160": (5, 32, 32, 96, 600, 577, (0, 13, 576, 577, 200)),
}


def make_decode(name, device, seed=21):
    b, hq, hkv, d, max_len, end, starts = DECODE[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, hq, d), generator=gen, device=device).to(torch.bfloat16)
    # a layer of a stacked cache: read through its strides, no copy
    stack = torch.randn((2, 2, b, max_len, hkv, d), generator=gen, device=device)
    ck, cv = stack.to(torch.bfloat16)[:, 1]
    starts = torch.tensor(starts, dtype=torch.int32, device=device)
    end = torch.tensor(end, dtype=torch.int32, device=device)
    return q, ck, cv, starts, end


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_attention_kernel_matches_plain(cuda, name):
    q, ck, cv, starts, end = make_decode(name, cuda)
    rows = torch.arange(ck.shape[1], device=cuda)
    outside = ~((rows[None] >= starts[:, None]) & (rows[None] < end))
    ck_nan, cv_nan = ck.clone(), cv.clone()
    ck_nan[outside] = float("nan")  # never loaded: cannot reach the output
    cv_nan[outside] = float("nan")
    before = dec.decode_attention.launches
    out, m, l = dec.decode_attention(q, ck_nan, cv_nan, starts, end)
    torch.cuda.synchronize()
    assert dec.decode_attention.launches == before + 1
    w_out, w_m, w_l = dec.plain_decode_attention(q, ck, cv, starts, end)
    assert out.dtype == torch.bfloat16 and m.dtype == l.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(m).all() and torch.isfinite(l).all()
    torch.testing.assert_close(out.float(), w_out.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(m, w_m, atol=1e-5, rtol=ML_RTOL)
    torch.testing.assert_close(l, w_l, atol=1e-6, rtol=ML_RTOL)
    empty = (end - starts.clamp(max=int(end))) <= 0
    assert not out[empty].any() and not l[empty].any() and (m[empty] == -1e30).all()


@pytest.mark.parametrize("name", ["path_2b", "ragged", "empty_and_one_row"])
def test_cached_decode_attention_matches_two_part(cuda, name):
    q, ck, cv, starts, end = make_decode(name, cuda)
    b, hq, d = q.shape
    gen = torch.Generator(device=cuda).manual_seed(22)
    k, v = (torch.randn((b, 1, ck.shape[2], d), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    kv_mask = torch.arange(ck.shape[1], device=cuda)[None] >= starts[:, None]
    got = dec.cached_decode_attention(q[:, None], k, v, ck, cv, end, kv_mask)
    want = two_part_cached_attention(q[:, None], k, v, ck, cv, int(end), kv_mask)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


def nan_outside(ck, cv, starts, end):
    """Copies of the cache layers with NaN in every row outside the windows."""
    rows = torch.arange(ck.shape[1], device=ck.device)
    outside = ~((rows[None] >= starts[:, None]) & (rows[None] < end))
    ck_nan, cv_nan = ck.clone(), cv.clone()
    ck_nan[outside] = float("nan")
    cv_nan[outside] = float("nan")
    return ck_nan, cv_nan


def make_new_token(q, ck, seed=23):
    """The current token's k and v [B, 1, Hkv, D] as the decoder hands them
    over: views of one projection row."""
    b, _, d = q.shape
    gen = torch.Generator(device=q.device).manual_seed(seed)
    row = torch.randn((b, 1, 3 * ck.shape[2], d), generator=gen, device=q.device)
    row = row.to(torch.bfloat16)
    return row[:, :, : ck.shape[2]], row[:, :, 2 * ck.shape[2] :]


@pytest.mark.parametrize("name", list(DECODE))
def test_cached_decode_attention_kernel_matches_plain(cuda, name):
    q, ck, cv, starts, end = make_decode(name, cuda)
    k, v = make_new_token(q, ck)
    ck_nan, cv_nan = nan_outside(ck, cv, starts, end)
    before = dec.cached_decode_attention.launches, dec.decode_attention.launches
    got = dec.cached_decode_attention(q[:, None], k, v, ck_nan, cv_nan, end, starts=starts)
    torch.cuda.synchronize()
    assert (dec.cached_decode_attention.launches, dec.decode_attention.launches) == (
        before[0] + 1, before[1])
    want = dec.plain_cached_decode_attention(q[:, None], k, v, ck, cv, end, starts=starts)
    assert got.shape == q[:, None].shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    empty = (end - starts.clamp(max=int(end))) <= 0
    g = q.shape[1] // ck.shape[2]
    assert torch.equal(got[empty, 0], v[empty, 0].repeat_interleave(g, dim=1))


def test_cached_decode_attention_replays_in_a_graph(cuda):
    q, ck, cv, starts, end = make_decode("ragged", cuda)
    k, v = make_new_token(q, ck)
    eager = dec.cached_decode_attention(q[:, None], k, v, ck, cv, end, starts=starts)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dec.cached_decode_attention(q[:, None], k, v, ck, cv, end, starts=starts)
    for _ in range(3):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


@pytest.mark.parametrize("name", ["phi3_d96", "path_2b_b16"])
def test_cached_decode_attention_replays_in_a_graph_in_the_wide_form(cuda, name):
    """Phi-3-mini's decode step and the 2B step at B = 16: the fused entry and
    the window alone, replayed three times, bit-equal to the eager calls."""
    q, ck, cv, starts, end = make_decode(name, cuda)
    k, v = make_new_token(q, ck)
    eager = dec.cached_decode_attention(q[:, None], k, v, ck, cv, end, starts=starts)
    window = dec.decode_attention(q, ck, cv, starts, end)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dec.cached_decode_attention(q[:, None], k, v, ck, cv, end, starts=starts)
        replayed_window = dec.decode_attention(q, ck, cv, starts, end)
    for _ in range(3):
        replayed.zero_()
        for t in replayed_window:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
        assert all(torch.equal(a, b) for a, b in zip(replayed_window, window))


def test_cached_decode_attention_rejects_what_it_does_not_take(cuda):
    q, ck, cv, starts, end = make_decode("mha_d64", cuda)
    k, v = make_new_token(q, ck)
    with pytest.raises(TypeError, match="bf16"):
        dec.cached_decode_attention(q[:, None].float(), k, v, ck, cv, end, starts=starts)
    with pytest.raises(TypeError, match="bf16"):
        dec.cached_decode_attention(q[:, None], k.float(), v, ck, cv, end, starts=starts)
    with pytest.raises(TypeError, match="device memory"):
        dec.cached_decode_attention(q[:, None], k, v, ck, cv, 301, starts=starts)
    with pytest.raises(ValueError, match="starts"):
        dec.cached_decode_attention(q[:, None], k, v, ck, cv, end, starts=starts.long())
    with pytest.raises(ValueError, match="current token"):
        dec.cached_decode_attention(q[:, None], k[:1], v[:1], ck, cv, end, starts=starts)


def test_decode_attention_rejects_what_it_does_not_take(cuda):
    q, ck, cv, starts, end = make_decode("mha_d64", cuda)
    with pytest.raises(TypeError, match="bf16"):
        dec.decode_attention(q.float(), ck, cv, starts, end)
    with pytest.raises(TypeError, match="device memory"):
        dec.decode_attention(q, ck, cv, starts, 301)
    with pytest.raises(ValueError, match="starts"):
        dec.decode_attention(q, ck, cv, starts.long(), end)
    shifted = torch.empty(ck.numel() + 1, dtype=ck.dtype, device=cuda)[1:].view(ck.shape)
    with pytest.raises(ValueError, match="aligned"):
        dec.decode_attention(q, shifted, cv, starts, end)
    with pytest.raises(ValueError, match="unsupported"):
        dec.decode_attention(q[:, :4], ck[:, :, :4], cv[:, :, :4], starts, end)
    with pytest.raises(ValueError, match="does not match"):
        dec.decode_attention(q[:1], ck, cv, starts[:1], end)


# ------------------------------------------------- the cached decoder paths --


def small_model(cuda, **flags):
    """Two decoder layers at the 2B head shape (16 query / 8 kv heads of 128)."""
    import dataclasses

    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.config import AssessorConfig, LLMConfig, VisionConfig

    llm = dataclasses.replace(LLMConfig.tiny(), hidden_size=2048, intermediate_size=512,
                              num_attention_heads=16, num_key_value_heads=8)
    # 4 heads of 64, a head dim the attention kernel takes
    vision = dataclasses.replace(VisionConfig.tiny(), hidden_size=256)
    cfg = AssessorConfig.tiny(stage=2).replace(llm=llm, vision=vision, img_context_token_id=7)
    return build_serving_model(cfg, device=cuda, seed=0, **flags), cfg


@pytest.mark.parametrize("mode", ["bf16", "w8a8", "w8a8_fused", "int8", "kv_int8"])
def test_prefill_and_decode_steps_on_the_card(cuda, mode):
    """Decode steps launch the kernel once per layer (never under kv_int8)
    and agree with the same steps on the plain decode attention."""
    from unittest import mock

    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models import internlm2
    from aigv_assessor_torch.models.internlm2 import KVCache

    flags = {"bf16": {}, "w8a8_fused": {"w8a8": True, "precision": Precision(
        fuse_quant={"vit", "llm"}, quant_rows={"vit", "llm"})}}.get(mode, {mode: True})
    model, cfg = small_model(cuda, **flags)
    fused = qf.rmsnorm_quant.launches, qf.silu_mul_quant.launches
    gen = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(10, cfg.llm.vocab_size, (4, 40), generator=gen, device=cuda)
    kv_mask = torch.ones((4, 48), dtype=torch.bool, device=cuda)
    kv_mask[1, :5] = False  # a left-padded row

    def run():
        cache = KVCache.init(cfg.llm, 4, 48, quantized=model.precision.kv_int8, device=cuda)
        outs = []
        with torch.inference_mode():
            logits, _, cache = model.prefill(model.embed_tokens(ids[:, :36]), cache,
                                             kv_mask=kv_mask)
            outs.append(logits[:, -1])
            for i in range(36, 40):
                logits, _, cache = model.decode_step(ids[:, i : i + 1], cache, kv_mask)
                outs.append(logits[:, -1])
        assert cache.index == 40 == int(cache.index_dev)
        return torch.stack(outs).float()

    before = dec.cached_decode_attention.launches, dec.decode_attention.launches
    got = run()
    layers = cfg.llm.num_hidden_layers
    # one fused launch per layer and step, the window-only entry never
    assert (dec.cached_decode_attention.launches - before[0],
            dec.decode_attention.launches - before[1]) == (
        0 if mode == "kv_int8" else 4 * layers, 0)
    # a prefill and 4 steps: K5a twice and K5b once per layer each
    per_pass = (2 * layers, layers) if mode == "w8a8_fused" else (0, 0)
    assert (qf.rmsnorm_quant.launches - fused[0], qf.silu_mul_quant.launches - fused[1]) == (
        5 * per_pass[0], 5 * per_pass[1])
    with mock.patch.object(internlm2, "cached_decode_attention",
                           dec.plain_cached_decode_attention):
        want = run()
    assert torch.isfinite(got).all()
    assert relative_l2(got, want) <= 2e-2


def test_shared_prefix_scores_on_the_card(cuda):
    from aigv_assessor_torch.cli.score import score_batch

    model, cfg = small_model(cuda)
    n_ctx = 4 * cfg.num_image_token + 1
    gen = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(10, cfg.llm.vocab_size, (2, 4, n_ctx + 3 + 12), generator=gen,
                        device=cuda)
    ids[:, :, : n_ctx + 3] = ids[:, :1, : n_ctx + 3]
    ids[:, :, 1 : 1 + n_ctx] = 7
    mask = torch.ones_like(ids, dtype=torch.bool)
    mask[:, 2, -3:] = False
    px = torch.randint(0, 256, (2, 4, 56, 56, 3), generator=gen, device=cuda, dtype=torch.uint8)
    # random weights close most of the head's ReLUs: compare what it reads
    rows = []
    model.mlpscore.register_forward_hook(
        lambda _m, args, _out: rows.append(args[0].float().reshape(2, 4, -1)))
    shared = score_batch(model, ids, px, mask, n_ctx + 3)
    full = score_batch(model, ids, px, mask)
    assert shared.shape == (2, 4) and torch.isfinite(shared).all()
    assert torch.isfinite(rows[0]).all() and rows[0].abs().max() > 0
    assert relative_l2(rows[0], rows[1]) <= 3e-2  # two bf16 forwards of two layers
    torch.testing.assert_close(shared, full, atol=2e-2, rtol=5e-2)



@pytest.mark.parametrize("base", ["w8a8", "int8", "int4"])
def test_adapted_quantized_layer_on_the_card(cuda, base):
    """An adapter over a W8A8, int8 or int4 base in bf16, head-major out
    where W8A8 has that form: the card's call (the int8 product, K6 / K7)
    against the same layer on the CPU, where each wrapper runs its plain
    version; the adapter moves the output."""
    from aigv_assessor_torch.core.config import LoRAConfig
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models.lora import make_linear

    precision = Precision(w8a8=base == "w8a8", int8_weights=base == "int8",
                          int4_weights=base == "int4")
    heads = 24 if base == "w8a8" else None
    layer = make_linear(2048, 3072, bias=True, lora=LoRAConfig(r=8, alpha=16), heads=heads,
                        precision=precision).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        layer.load_float_weight_(torch.randn(3072, 2048, generator=gen) * 0.02)
        layer.bias.copy_(torch.randn(3072, generator=gen) * 0.1)
        layer.lora_a.copy_(torch.randn(2048, 8, generator=gen) * 0.02)
        layer.lora_b.copy_(torch.randn(8, 3072, generator=gen) * 0.02)
    x = (torch.randn(2, 300, 2048, generator=gen)).to(torch.bfloat16)
    launches = (wo.int8_matmul.launches, wo.int4_matmul.launches)
    with torch.no_grad():
        want = layer.eval()(x).float()
        got = layer.to(cuda)(x.to(cuda))
        rows = layer.rows(x.to(cuda))
    torch.cuda.synchronize()
    assert (wo.int8_matmul.launches - launches[0], wo.int4_matmul.launches - launches[1]) == (
        2 * (base == "int8"), 2 * (base == "int4"))
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert relative_l2(got.float().cpu(), want) <= 2e-2
    flat = got.transpose(1, 2).reshape(2, 300, -1) if heads else got
    assert torch.equal(flat, rows)  # the delta added before the view
    with torch.no_grad():
        layer.lora_b.zero_()
        assert relative_l2(layer.rows(x.to(cuda)).float(), rows.float()) > 1e-2


def test_decode_step_with_live_adapters_replays_in_a_graph(cuda):
    """A decode step under live rank-4 adapters (bf16): `wqkv` and `wo` in
    their row-major adapted form beside the decode-attention kernel,
    captured in a CUDA graph and replayed, bit-equal to the eager step; and
    within bf16 rounding of the step with the adapters merged."""
    import dataclasses

    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.config import AssessorConfig, LLMConfig, VisionConfig
    from aigv_assessor_torch.models.internlm2 import KVCache

    llm = dataclasses.replace(LLMConfig.tiny(), hidden_size=2048, intermediate_size=512,
                              num_attention_heads=16, num_key_value_heads=8)
    vision = dataclasses.replace(VisionConfig.tiny(), hidden_size=256)
    cfg = AssessorConfig.tiny(stage=2, use_backbone_lora=4, use_llm_lora=4).replace(
        llm=llm, vision=vision, img_context_token_id=7)
    model = build_serving_model(cfg, device=cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(6)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen, device=cuda) * 0.05)
    ids = torch.randint(10, cfg.llm.vocab_size, (4, 37), generator=gen, device=cuda)
    kv_mask = torch.ones((4, 48), dtype=torch.bool, device=cuda)
    with torch.inference_mode():
        cache = KVCache.init(cfg.llm, 4, 48, device=cuda)
        _, _, cache = model.prefill(model.embed_tokens(ids[:, :36]), cache, kv_mask=kv_mask)
        saved = cache.k.clone(), cache.v.clone()
        token = ids[:, 36:37].clone()
        launches = dec.cached_decode_attention.launches
        eager, _, _ = model.decode_step(token, cache, kv_mask)
        assert dec.cached_decode_attention.launches - launches == cfg.llm.num_hidden_layers
        eager = eager.clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # warm-up off the capture
            model.decode_step(token, cache, kv_mask)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured, _, _ = model.decode_step(token, cache, kv_mask)
        for _ in range(2):
            cache.k.copy_(saved[0])
            cache.v.copy_(saved[1])
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, eager)
    merged = build_serving_model(cfg, device=cuda, seed=0,
                                 weights={k: v.float() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        cache = KVCache.init(cfg.llm, 4, 48, device=cuda)
        _, _, cache = merged.prefill(merged.embed_tokens(ids[:, :36]), cache, kv_mask=kv_mask)
        step, _, _ = merged.decode_step(token, cache, kv_mask)
    assert relative_l2(step.float(), eager.float()) <= 3e-2  # bf16 forwards of two layers

# ------------------------------------------------- fp8 decode matmul (K9) --

FP8_TOL = 1e-3  # relative L2 to the plain version rounded to bf16
# (M, K, N): the probe's shapes at its decode rows, M > 8 (two row blocks),
# and a ragged case: K off the 16-byte spans and rows, N off the 16 channels
FP8_SHAPES = [(8, 2048, 4096), (1, 2048, 16384), (4, 8192, 2048), (3, 2050, 4100),
              (20, 2048, 1000), (8, 17, 40)]


@pytest.mark.parametrize("shape", FP8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fp8_kernel_matches_plain(cuda, shape):
    from aigv_assessor_torch.ops import fp8_matmul as f8

    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((n, k), generator=gen, device=cuda) * 0.02
    w[n // 2] = 0.0  # an all-zero channel: output exactly 0
    w8, scale = f8.quantize_weight_fp8(w)
    assert not torch.isin(w8.view(torch.uint8), torch.tensor([0x7F, 0xFF], device=cuda)).any()
    before = f8.fp8_matmul.launches
    got = f8.fp8_matmul(x, w8, scale)
    torch.cuda.synchronize()
    assert f8.fp8_matmul.launches == before + 1
    want = f8.plain_fp8_matmul(x, w8, scale)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert relative_l2(got, want) <= FP8_TOL
    assert not got[:, n // 2].any()
    lead = f8.fp8_dense_apply(x.view(1, m, k), w8, scale)
    torch.testing.assert_close(lead.view(m, n), got, atol=0, rtol=0)


def test_fp8_kernel_rejects_what_it_does_not_take(cuda):
    from aigv_assessor_torch.ops import fp8_matmul as f8

    x = torch.randn((4, 256), device=cuda).to(torch.bfloat16)
    w8, scale = f8.quantize_weight_fp8(torch.randn((128, 256), device=cuda))
    with pytest.raises(TypeError, match="bf16"):
        f8.fp8_matmul(x.float(), w8, scale)
    with pytest.raises(TypeError, match="bf16"):
        f8.fp8_matmul(x, w8, scale, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="w8"):
        f8.fp8_matmul(x, w8.view(torch.int8), scale)
    with pytest.raises(ValueError, match="w8"):
        f8.fp8_matmul(x[:, :200], w8, scale)
    with pytest.raises(ValueError, match="scale"):
        f8.fp8_matmul(x, w8, scale[:100])
    with pytest.raises(ValueError, match="contiguous"):
        f8.fp8_matmul(x, w8.t().contiguous().t(), scale)
    with pytest.raises(ValueError, match="contiguous"):
        f8.fp8_matmul(x, w8, scale.cpu())


# K9's split borders (M, K, N): tile counts on either side of this card's
# SM count and of twice it, where the plan's split (8 or 16 warps an item)
# and its streams change; K = 8256 (129 steps, which neither split divides),
# K below one step, N below one tile, M across the row blocks
def fp8_split_borders(sms):
    tiles = (sms // 2, sms - 1, sms, sms + 1, 2 * sms - 1, 2 * sms, 2 * sms + 1)
    return ([(m, 8192, 16 * t) for m in (1, 8) for t in tiles]
            + [(8, 8256, 2048), (17, 8256, 2064), (1, 63, 15), (9, 100, 3), (5, 17, 40)])


def test_fp8_kernel_at_every_split_border(cuda):
    from aigv_assessor_torch.ops import fp8_matmul as f8

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(19)
    splits, forms = set(), set()
    for m, k, n in fp8_split_borders(sms):
        plan = f8.launch_plan(m, n, k)
        assert plan == f8.matvec_plan(m, n, k, sms=sms), (m, k, n)
        splits.add(plan.split)
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=cuda) * 0.02
        w[n // 2] = 0.0
        w8, scale = f8.quantize_weight_fp8(w)
        form = f8.fp8_form(m, k, n, x, w8, sms)
        forms.add(form)
        before = dict(f8.fp8_matmul.form_launches)
        got = f8.fp8_matmul(x, w8, scale)
        assert f8.fp8_matmul.form_launches[form] == before[form] + 1
        want = f8.plain_fp8_matmul(x, w8, scale)
        for body in f8.FORMS if k % 16 == 0 else ("tiles",):
            y = f8._launch_form(body, x, w8, scale)
            torch.cuda.synchronize()
            assert relative_l2(y, want) <= FP8_TOL, (m, k, n, plan, body)
            assert not y[:, n // 2].any()
            # no atomics: a second launch gives the same bits
            torch.testing.assert_close(f8._launch_form(body, x, w8, scale), y, atol=0, rtol=0)
            if body == form:
                torch.testing.assert_close(got, y, atol=0, rtol=0)
    assert splits == {8, 16} and forms == set(f8.FORMS)


def test_fp8_kernel_takes_every_finite_code_and_replays_in_a_graph(cuda):
    from aigv_assessor_torch.ops import fp8_matmul as f8

    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8)
    n, k = 272, 2048
    i = torch.arange(n * k)
    w8 = codes[(7 * i + i // k) % codes.numel()].view(n, k).to(cuda).view(torch.float8_e4m3fn)
    gen = torch.Generator(device=cuda).manual_seed(23)
    scale = torch.rand(n, generator=gen, device=cuda) * 1e-3 + 1e-4
    for m in (1, 8, 12):
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        want = f8.plain_fp8_matmul(x, w8, scale)
        for form in f8.FORMS:
            got = f8._launch_form(form, x, w8, scale)
            assert relative_l2(got, want) <= FP8_TOL
            static = torch.empty_like(got)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static.copy_(f8._launch_form(form, x, w8, scale))
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                torch.testing.assert_close(static, got, atol=0, rtol=0)


def test_fp8_kernel_converts_every_finite_code_exactly(cuda):
    """x the identity's first 8 rows and scale 1: y[m, n] is w8[n, m] as bf16,
    one nonzero product summed and scaled exactly; the first 8 columns hold
    every finite e4m3 code. Both forms."""
    from aigv_assessor_torch.ops import fp8_matmul as f8

    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8)
    n, k = 256, 2048
    idx = torch.arange(n)[:, None] + 7 * torch.arange(k)[None, :]
    w8 = codes[idx % codes.numel()].to(cuda).view(torch.float8_e4m3fn)
    assert set(w8[:, :8].view(torch.uint8).unique().tolist()) == set(codes.tolist())
    x = torch.eye(8, k, device=cuda).to(torch.bfloat16)
    for form in f8.FORMS:
        y = f8._launch_form(form, x, w8, torch.ones(n, device=cuda))
        torch.testing.assert_close(y, w8[:, :8].to(torch.bfloat16).t(), atol=0, rtol=0)


def test_fp8_stream_form_refuses_rows_off_16_bytes(cuda):
    from aigv_assessor_torch.ops import fp8_matmul as f8

    x = torch.randn((4, 2050), device=cuda).to(torch.bfloat16)
    w8, scale = f8.quantize_weight_fp8(torch.randn((512, 2050), device=cuda))
    assert f8.fp8_form(4, 2050, 512, x, w8, 132) == "tiles"
    with pytest.raises(RuntimeError, match="stream"):
        f8._launch_form("stream", x, w8, scale)
    torch.testing.assert_close(f8._launch_form("tiles", x, w8, scale), f8.fp8_matmul(x, w8, scale),
                               atol=0, rtol=0)
