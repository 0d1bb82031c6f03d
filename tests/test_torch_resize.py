"""`ops/preprocess.resize_normalize` with a real resize against JAX's
(`jax.image.resize(method="bicubic")`), on the CPU, at the model's 448 px
from tests import _torch_threads  # noqa: F401  (before torch does work)
from the frame sizes the scoring path meets: 512x640, 720x1280, 300x500,
336x336 (growing) and 448x448 (no resize), under each normalization.

- fp32: within 1e-6 on the resized [0, 1] values, which the normalization
  scales by 1 / std: 1e-6 / min(std) on its output;
- bf16: equal, or one ulp apart (the fp32 values on either side of a bf16
  rounding boundary; near zero, within the fp32 bound), in at most 1e-3 of
  the elements;
- the exact anti-aliased bicubic (float64) 1e-5 to 1e-4 from JAX's fp32
  resize, the port's weights within 1e-6 of it, on [0, 1] values;
- `resize_weights` against JAX's `compute_weight_mat` compiled, as inside
  `jax.image.resize`: its columns sum to one and sit within 5e-7 (four
  fp32 ulps of 1) of JAX's (the eager function, which takes no fused
  multiply-add, is up to 1e-5 away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.ops import preprocess as tpre
from aigv_assessor_tpu.data.constants import NORMALIZE_STATS
from aigv_assessor_tpu.ops import preprocess as jpre

SIZES = [(512, 640), (720, 1280), (300, 500), (336, 336), (448, 448)]


@pytest.mark.parametrize("normalize_type", ["imagenet", "clip"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_resize_normalize_equals_jax(hw, normalize_type):
    h, w = hw
    px = np.random.default_rng(h + w).integers(0, 256, (2, 2, h, w, 3), dtype=np.uint8)
    got = tpre.resize_normalize(torch.from_numpy(px), size=448, normalize_type=normalize_type,
                                dtype=torch.float32)
    want = jpre.resize_normalize(jnp.asarray(px), size=448, normalize_type=normalize_type,
                                 dtype=jnp.float32)
    assert tuple(got.shape) == want.shape == (2, 2, 448, 448, 3)
    tol = 1e-6 / min(NORMALIZE_STATS[normalize_type][1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)

    got = tpre.resize_normalize(torch.from_numpy(px), size=448, normalize_type=normalize_type)
    want = jpre.resize_normalize(jnp.asarray(px), size=448, normalize_type=normalize_type)
    assert got.dtype == torch.bfloat16
    g, j = got.float().numpy(), np.asarray(want).astype(np.float32)
    # one bf16 ulp at the larger magnitude; across zero, the fp32 bound
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(g), np.abs(j)) + 1e-30)) - 7)
    assert (np.abs(g - j) <= np.maximum(ulp, tol)).all()
    assert (g != j).mean() <= 1e-3


@pytest.mark.parametrize("src", [640, 1280, 500, 336, 56])
def test_resize_weights_are_jax_weights(src):
    from jax._src.image import scale as jscale

    want = np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
        src, 448, 448 / src, 0.0, jscale._fill_keys_cubic_kernel, True))())
    got = tpre.resize_weights(src, 448).numpy()
    assert got.shape == want.shape == (src, 448) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)  # 4 fp32 ulps of 1


def test_exact_bicubic_misses_jax_fp32():
    """Why the port rebuilds JAX's compiled weights: the exact anti-aliased
    bicubic (torch's `F.interpolate(antialias=True)` in float64) lands 1e-5
    to 1e-4 from JAX's fp32 `jax.image.resize` on [0, 1] values, far outside
    the 1e-6 the port holds (its sample positions are fp32 multiply-adds)."""
    import torch.nn.functional as F

    px = np.random.default_rng(9).integers(0, 256, (2, 512, 640, 3), dtype=np.uint8)
    x = torch.from_numpy(px).double().permute(0, 3, 1, 2) / 255.0
    exact = F.interpolate(x, size=(448, 448), mode="bicubic", antialias=True,
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    jax_fp32 = np.asarray(jax.image.resize(jnp.asarray(px, jnp.float32) / 255.0,
                                           (2, 448, 448, 3), method="bicubic"))
    ours = torch.einsum("nHWc,Hh->nhWc", x.permute(0, 2, 3, 1),
                        tpre.resize_weights(512, 448).double())
    ours = torch.einsum("nhWc,Ww->nhwc", ours,
                        tpre.resize_weights(640, 448).double()).float().numpy()
    assert 1e-5 < np.abs(exact - jax_fp32).max() < 1e-4
    assert np.abs(ours - jax_fp32).max() <= 1e-6
