"""The CUDA flash-attention kernel against its plain version, on the card.

jax-free, so that it runs where jax is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Both sides get the same bf16 inputs; the plain version computes in fp32 from
them, the kernel accumulates in fp32 and rounds P to bf16 before the PV
product, as the Pallas kernel does. Tolerance atol = rtol = 2e-2, about four
bf16 ulps at the outputs' scale.
"""

import pytest
import torch

from aigv_assessor_torch.ops.flash_attention import flash_attention_qkv, plain_attention_qkv

pytestmark = pytest.mark.gpu

TOL = 2e-2

# (B, hq, hkv, S, D, causal, kv_valid): the two forms the scoring path runs at
# 2B scale, and a small ragged shape whose keys past kv_valid hold +-1e3
SHAPES = {
    "vit": (32, 16, 16, 1032, 64, False, 1025),
    "llm": (4, 16, 8, 2113, 128, True, None),
    "ragged": (2, 4, 4, 200, 64, False, 150),
}


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
